"""The benchmark of the PyTorch and CUDA port (`cadence_tpu_torch`).

`run.py` is the one command; BENCHMARK.json at the checkout's root names
the cells, and each configuration, traffic mix, entry and per-layer metric
is a file of its own under this folder, found by its name (README.md).
"""
