"""The plain references that decide ``correct``: plain PyTorch, float32
with TF32 off unless a lower precision is asked for (the controls).
Nothing here imports the program (`repro_torch`), the JAX package or
JAX; every input is drawn again from the seed (`bench/weights.py`)."""
