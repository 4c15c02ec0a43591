"""Deterministic synthetic LM data pipeline.

Design mirrors a production host-sharded loader:
  * step-indexed determinism — batch(step) is a pure function of
    (seed, step), so restarts and elastic re-meshes replay identically
    (the checkpoint stores only the step),
  * per-host sharding — each host materializes only its slice
    (host_id, n_hosts); batches are numpy arrays, and the driver
    (`repro_torch.train_lm`) moves them to its device,
  * structured stream — a deterministic Markov-ish token stream rather than
    iid noise, so training loss measurably decreases (``train_lm
    --restart-demo``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_seq: int = 0
    d_model: int = 0


class SyntheticLMData:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.host_id)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Markov stream: next token = (a*prev + noise) % V; learnable."""
        cfg = self.cfg
        rng = self._rng(step)
        b, l, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        start = rng.integers(0, v, size=(b, 1))
        mult = 31
        noise = rng.integers(0, 7, size=(b, l))
        toks = np.zeros((b, l + 1), np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(l):
            toks[:, t + 1] = (mult * toks[:, t] + noise[:, t]) % v
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend_seq:
            out["frontend"] = rng.standard_normal(
                (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        return out

    def global_batch_shape(self) -> dict[str, tuple]:
        cfg = self.cfg
        shapes = {
            "tokens": (cfg.global_batch, cfg.seq_len),
            "labels": (cfg.global_batch, cfg.seq_len),
        }
        if cfg.frontend_seq:
            shapes["frontend"] = (cfg.global_batch, cfg.frontend_seq,
                                  cfg.d_model)
        return shapes
