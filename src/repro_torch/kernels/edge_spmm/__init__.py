"""Incidence SpMM of the dilated Laplacian matvec (kernels K1 and K2)."""
