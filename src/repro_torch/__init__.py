"""repro_torch: the MIREDO measured-execution path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The package mirrors ``src/repro/``'s tree and names and shares no code
with it: the optimizer modules under ``core/`` and ``configs/`` are this
package's own copies, and the kernels under ``kernels/`` are CUDA C++
built at first use (``kernels/_build.py``).
"""

__version__ = "0.1.0"
