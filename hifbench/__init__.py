"""hifbench: the benchmark of hifir_tpu_torch, the PyTorch and CUDA port.

``python3 hifbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell or one per-layer metric is a file of its own, found
by name (README.md).  The yardstick lives here: the matrix generators, the
plain reference (:mod:`hifbench.reference`, numpy and scipy only), the
comparisons that decide ``correct``, the window arithmetic, the trace
reduction, the table of peaks and the operation and byte counts.
"""
