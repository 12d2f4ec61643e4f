"""Preprocessing: matching/scaling + reordering (the port's copy of
``hifir_tpu/pre``, numpy paths only)."""
