"""Step builders over the port's models (`repro_torch.models`): the
train step with its optimizer (`optimizer`), and the prefill and decode
steps (`steps`), as in ``src/repro/train/``."""
