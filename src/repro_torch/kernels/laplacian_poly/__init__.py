"""Dense-Laplacian limit-series step (kernels K5 and K6)."""
