"""Device demos of the port: the counterparts of the JAX package's
``examples/demo_tpu_batch.py``, ``demo_pseudoinverse_device.py``,
``demo_partitioned.py``, ``distprec_scale.py`` and ``partition_study.py``.

Each generates its own operator, runs as
``python -m hifir_tpu_torch.examples.<name> [--device cuda]``, prints the
lines its JAX counterpart prints and returns its results from ``main``.
"""
