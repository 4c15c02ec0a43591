"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`).

`bench/run.py` runs one cell once; `bench/README.md` says how a cell, a
configuration, a traffic mix and a per-layer metric are found by name
from their files. Nothing here imports the JAX package or JAX."""
