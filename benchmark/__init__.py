"""The benchmark of the PyTorch and CUDA port ``sdvar_tpu_torch``: see
``run.py``, and ``PERF.md`` at the root of the repository."""
