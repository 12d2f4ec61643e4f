"""Host sparse containers."""
