"""radbench: the benchmark of the PyTorch/CUDA port ``ecckd_tpu_torch``.
See radbench/README.md; ``python3 -m radbench.run`` runs one cell."""
