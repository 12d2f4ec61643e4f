"""Model problem generators."""
