"""Step builders over the port's models (`repro_torch.models`): the
serving half of ``src/repro/train/``, prefill and decode."""
