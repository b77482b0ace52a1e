"""Hand-written GPU kernels (Pallas on the Triton route)."""
