"""Hand-written Hopper kernels, one package per kernel: ``ref.py`` holds
the plain PyTorch version, ``csrc/*.cu`` the CUDA source, ``kernel.py`` the
ctypes binding and launch counter, ``ops.py`` the public op."""
