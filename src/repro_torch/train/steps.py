"""Serve step builders for every family: ``make_prefill_step`` /
``make_decode_step`` carry KV caches, SSM states or both (hybrid) or the
encoder-decoder's (self KV, cross K/V, memory); ``init_caches`` makes a
decode-mode cache of zeros.

The training half of the reference's module (``lm_loss``,
``make_train_step``, ``init_train_state``) waits for the optimizer and
the gradient compression (ROADMAP Queue A, the train step). The steps run
without autograd.
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
            compute_dtype=step_cfg.compute_dtype,
            frontend_embeds=batch.get("frontend"))
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
                    compute_dtype, device=None, *,
                    quant: bool = False) -> KVCache:
    shape = (n, batch, max_seq, kv, hd)
    zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if quant:
        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       length=zeros((n, batch), torch.int32),
                       k_scale=zeros(shape[:-1] + (1,), torch.float32),
                       v_scale=zeros(shape[:-1] + (1,), torch.float32))
    return KVCache(k=zeros(shape, compute_dtype),
                   v=zeros(shape, compute_dtype),
                   length=zeros((n, batch), torch.int32))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                compute_dtype=torch.bfloat16, device=None):
    """Decode-mode caches (zeros), stacked along a leading layer axis, as
    the reference's: KV caches (dense, moe, vlm; int8 under ``KV_QUANT``),
    SSM states (ssm), (SSM states over the layers, KV caches over the
    groups) (hybrid), (KV caches, (cross K, cross V) over ``frontend_seq``
    positions or 1024, memory) (encdec). The hybrid's and the
    encoder-decoder's KV caches are in ``compute_dtype`` whatever
    ``KV_QUANT`` says, as in the reference."""
    transformer._check_family(cfg)
    fam, hd, kvh = cfg.family, cfg.resolved_head_dim, cfg.n_kv_heads
    kv = lambda n, quant=False: _kv_cache_stack(
        n, batch, max_seq, kvh, hd, compute_dtype, device, quant=quant)
    if fam in ("dense", "moe", "vlm"):
        return kv(cfg.n_layers, attn_mod.KV_QUANT)
    if fam in ("ssm", "hybrid"):
        st = init_ssm_state(batch, cfg, cfg.d_model, device=device)
        states = SSMState(*(torch.zeros((cfg.n_layers,) + t.shape,
                                        dtype=t.dtype, device=device)
                            for t in st))
        return states if fam == "ssm" else \
            (states, kv(transformer.hybrid_groups(cfg)[0]))
    mem = cfg.frontend_seq or 1024
    cross = tuple(torch.zeros((cfg.n_layers, batch, mem, kvh, hd),
                              dtype=compute_dtype, device=device)
                  for _ in range(2))
    return kv(cfg.n_layers), cross, torch.zeros(
        (batch, mem, cfg.d_model), dtype=compute_dtype, device=device)
