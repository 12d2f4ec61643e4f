"""Host factorization of the dense last level."""
