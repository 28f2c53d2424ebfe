"""Fused mu-EigenGame panel passes (kernels K3 and K4)."""
