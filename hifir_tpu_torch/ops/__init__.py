"""Device operators and their kernels (K1, K2, K7)."""
