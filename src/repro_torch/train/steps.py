"""Serve step builders for the ``dense`` and ``ssm`` families:
``make_prefill_step`` / ``make_decode_step`` carry KV caches or SSM
states, ``init_caches`` makes a decode-mode cache of zeros.

The training half of the reference's module (``lm_loss``,
``make_train_step``, ``init_train_state``) waits for the optimizer and
the gradient compression (ROADMAP Queue A item 5). The steps run without
autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMState, init_ssm_state


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The reference's serving fields; its training fields come with the
    train step."""
    use_flash: bool = False
    compute_dtype: Any = torch.bfloat16


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig):
    @torch.no_grad()
    def prefill(params, batch):
        out = transformer.forward(
            params, cfg, batch["tokens"], mode="prefill",
            use_flash=step_cfg.use_flash,
            compute_dtype=step_cfg.compute_dtype)
        return out.logits[:, -1], out.caches

    return prefill


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig):
    """The decode step attends through the plain product whatever
    ``use_flash`` says, as the reference's does."""
    @torch.no_grad()
    def decode(params, batch, caches):
        out = transformer.forward(
            params, cfg, batch["tokens"], mode="decode", caches=caches,
            compute_dtype=step_cfg.compute_dtype)
        return out.logits[:, -1], out.caches

    return decode


def _kv_cache_stack(n: int, batch: int, max_seq: int, kv: int, hd: int,
                    compute_dtype, device=None) -> KVCache:
    shape = (n, batch, max_seq, kv, hd)
    zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if attn_mod.KV_QUANT:
        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       length=zeros((n, batch), torch.int32),
                       k_scale=zeros(shape[:-1] + (1,), torch.float32),
                       v_scale=zeros(shape[:-1] + (1,), torch.float32))
    return KVCache(k=zeros(shape, compute_dtype),
                   v=zeros(shape, compute_dtype),
                   length=zeros((n, batch), torch.int32))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                compute_dtype=torch.bfloat16, device=None):
    """Decode-mode caches (zeros), stacked along a leading layer axis."""
    transformer._check_family(cfg)
    if cfg.family == "dense":
        return _kv_cache_stack(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                               cfg.resolved_head_dim, compute_dtype, device)
    st = init_ssm_state(batch, cfg, cfg.d_model, device=device)
    return SSMState(*(torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                                  device=device) for t in st))
