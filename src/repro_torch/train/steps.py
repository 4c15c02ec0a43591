"""Train and serve step builders for every family.

``make_train_step``: the cross-entropy LM loss (+ the MoE aux loss), its
gradients, the AdamW update (`train.optimizer`), optional microbatch
gradient accumulation and the cross-pod int8 gradient compression with
error feedback (`runtime.compression`). ``make_prefill_step`` /
``make_decode_step``: the serving counterparts carrying KV caches, SSM
states or both (hybrid) or the encoder-decoder's (self KV, cross K/V,
memory); ``init_caches`` makes a decode-mode cache of zeros.

The model's parameters carry no gradient (``requires_grad=False``) and
the serve steps run under ``torch.no_grad()``: a served model never
builds an autograd graph. Only the train step turns gradients on, for
the parameters of its own state, for as long as it takes them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import no_shard
from repro_torch.models.ssm import SSMState, init_ssm_state
from repro_torch.runtime.compression import compress_grads_with_feedback, \
    init_residuals
from repro_torch.runtime.spans import span
from repro_torch.sharding.rules import is_dtensor, local_microbatches
from repro_torch.train.optimizer import AdamWState, OptimizerConfig, \
    adamw_update, init_adamw


class TrainState(NamedTuple):
    params: transformer.LM
    opt: AdamWState
    residuals: dict | None          # error-feedback state (compression)
    rng: int                        # the reference's key: a seed, unread


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The reference's fields and defaults. ``remat`` acts in the train
    step only; the serve steps read ``use_flash`` and ``compute_dtype``."""
    microbatches: int = 1
    remat: bool = True
    use_flash: bool = False
    compress_pod_grads: bool = False
    compute_dtype: Any = torch.bfloat16
    aux_loss_weight: float = 0.01


def token_loss(logits, labels, lo: int = 0, reduce=None):
    """The mean cross-entropy over the positions whose label is >= 0, from
    float32 logits and a stable logsumexp whose max carries no gradient
    (the reference's ``stop_gradient``). The label logit is a gather
    where the reference contracts with a one-hot: the same value, and no
    (B, L, V) one-hot. On logits split over ranks (`layers.Shard.loss`)
    ``lo`` is the vocab id of the first column and ``reduce(op, t, over)``
    reduces over the other ranks' vocab slices and tokens: the max and
    the sum over ``vocab``, the label logit as the sum of the one rank's
    entry that holds it and the others' zeros, the token sums over
    ``tokens``. Every value is then the one-device one, and each rank's
    gradient is its own shard's."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if reduce is not None:
        m = reduce("max", m, "vocab")
    s = torch.sum(torch.exp(logits - m), dim=-1)
    if reduce is not None:
        s = reduce("sum", s, "vocab")
    lse = m.squeeze(-1) + torch.log(s)
    idx = labels - lo
    label_logit = torch.gather(logits, -1, idx.clamp(
        0, logits.shape[-1] - 1)[..., None]).squeeze(-1)
    if reduce is not None:
        label_logit = reduce("sum", torch.where(
            (idx >= 0) & (idx < logits.shape[-1]), label_logit, 0.0),
            "vocab")
    mask = (labels >= 0).to(torch.float32)
    total, count = torch.sum((label_logit - lse) * mask), torch.sum(mask)
    if reduce is not None:
        total, count = (reduce("sum", t, "tokens") for t in (total, count))
    return -total / torch.clamp_min(count, 1.0)


def lm_loss(params: transformer.LM, cfg: ModelConfig, tokens, labels, *,
            step_cfg: StepConfig, frontend=None, shard=no_shard):
    """Returns (loss + aux_loss_weight * aux, {"loss", "aux_loss"}), the
    loss `token_loss` over the forward's logits (``shard.loss``: on a
    mesh, on each rank's shards)."""
    out = transformer.forward(
        params, cfg, tokens, mode="train", use_flash=step_cfg.use_flash,
        remat=step_cfg.remat, compute_dtype=step_cfg.compute_dtype,
        frontend_embeds=frontend, shard=shard)
    loss = shard.loss(token_loss, out.logits, labels)
    total = loss + step_cfg.aux_loss_weight * out.aux_loss
    return total, {"loss": loss, "aux_loss": out.aux_loss}


@contextlib.contextmanager
def _grads_on(params: dict[str, torch.Tensor]):
    """The parameters require a gradient inside the block only."""
    for p in params.values():
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in params.values():
            p.requires_grad_(False)


def _placed(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient on its parameter's placements (a weight
    used on batch-sharded activations comes back as a partial sum); a
    plain one as it is."""
    if is_dtensor(param) and tuple(grad.placements) != \
            tuple(param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def loss_and_grads(model: transformer.LM, cfg: ModelConfig,
                   step_cfg: StepConfig, batch: dict, shard=no_shard):
    """(grads by parameter name, the loss, metrics) of one batch. With
    ``microbatches`` = mb > 1 the batch is split along its first axis
    (on a mesh into each rank's local chunks, the batch placed by
    `sharding.state.place_batch`): the grads are the sum of the
    microbatches' float32 grads over mb and the loss the sum of their
    totals (loss + the weighted aux loss) over mb, and the reported
    ``aux_loss`` is zero, all as the reference
    reports them (``steps.py:100-109``). Every parameter must be reached
    by the loss: one that is not raises, as does ``use_flash`` (the train
    mode of `transformer.forward`). On a mesh (``DTensor`` parameters and
    batch, ``shard`` the plan's) each gradient comes back on its
    parameter's placements, and the backward, remat's recomputation
    included, runs in ``shard.scope`` (`models.layers.Shard`)."""
    params = dict(model.named_parameters())
    names = list(params)
    mb = step_cfg.microbatches
    fr = batch.get("frontend")
    if batch["tokens"].shape[0] % mb:
        raise ValueError(f"batch {batch['tokens'].shape[0]} does not split "
                         f"into {mb} microbatches")
    # one microbatch is the batch as it is (``chunk`` on a DTensor split
    # along its rows gathers every row onto every rank)
    parts = [(batch["tokens"], batch["labels"], fr)] if mb == 1 else \
        list(zip(local_microbatches(batch["tokens"], mb),
                 local_microbatches(batch["labels"], mb),
                 local_microbatches(fr, mb) if fr is not None
                 else [None] * mb))
    acc = loss_sum = None
    with _grads_on(params), shard.scope(batch["tokens"]):
        for tokens, labels, frontend in parts:
            with span("train.forward"):
                total, metrics = lm_loss(model, cfg, tokens, labels,
                                         step_cfg=step_cfg,
                                         frontend=frontend, shard=shard)
            with span("train.backward"):
                g = torch.autograd.grad(total, [params[n] for n in names])
                g = [_placed(t, params[n]) for n, t in zip(names, g)]
            if mb == 1:
                return dict(zip(names, g)), metrics["loss"].detach(), \
                    {k: v.detach() for k, v in metrics.items()}
            if acc is None:
                acc = {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}
                loss_sum = 0.0
            for n, t in zip(names, g):
                acc[n] += t
            loss_sum = loss_sum + total.detach()
            del g, total, metrics
    loss = loss_sum / mb
    return {n: t / mb for n, t in acc.items()}, loss, {
        "loss": loss, "aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor, the same on every rank."""
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    step_cfg: StepConfig, shard=None):
    """``train_step(state, batch) -> (new state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` (B, L) and, for the vlm and encdec
    families, ``frontend`` (B, S, D). The grads (`loss_and_grads`), then
    the int8 compression with error feedback when ``compress_pod_grads``
    is set and the state has residuals, then AdamW. Both follow the
    reference's stacked tree: the compression scales each stacked leaf
    (every layer of a stack) as one tensor, and AdamW decays the leaves
    that are matrices there (every per-layer vector of a stack
    included). The update is in place: the new state holds the same
    parameter and moment tensors. Metrics: ``loss``, ``aux_loss``,
    ``lr``, ``grad_norm`` (0-d tensors on the parameters' device).

    ``shard`` is the plan's `ShardingPlan.shard_fn` on a mesh, as the
    reference's ``make_train_step(..., plan.shard_fn())``: the state's
    tensors are then ``DTensor``s (`sharding.state`) and the batch lies
    on the plan's batch spec. The gradient norm and the compression's
    scales reduce over every shard, and the metrics come back as plain
    tensors on every rank."""
    shard = shard or no_shard
    if step_cfg.use_flash:
        raise ValueError("use_flash: flash_attention has no backward, and "
                         "the reference cannot differentiate its own "
                         "kernel; the train step runs the plain product")

    def train_step(state: TrainState, batch: dict):
        with span("train.step"):
            grads, _, metrics = loss_and_grads(state.params, cfg, step_cfg,
                                               batch, shard)
            residuals = state.residuals
            if step_cfg.compress_pod_grads and residuals is not None:
                grads, residuals = compress_grads_with_feedback(grads,
                                                                residuals)
            with span("train.optimizer"):
                _, new_opt, opt_metrics = adamw_update(
                    opt_cfg, dict(state.params.named_parameters()), grads,
                    state.opt)
            return TrainState(params=state.params, opt=new_opt,
                              residuals=residuals, rng=state.rng + 1), \
                {k: _plain(v) for k, v in {**metrics, **opt_metrics}.items()}

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, step_cfg: StepConfig,
                     param_dtype=torch.float32, device=None,
                     place=None) -> TrainState:
    """A model drawn from ``seed`` on ``device``, zero AdamW moments and,
    under ``compress_pod_grads``, zero residuals, each beside its
    parameter. ``place(name, p)`` takes each parameter as soon as it is
    drawn (`transformer.init_model`; `sharding.state` lays it on a mesh).
    The step advances ``rng`` by one, as the reference folds 1 into its
    key; nothing in the step draws from it."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    model = transformer.init_model(cfg, gen, param_dtype, device, place)
    params = dict(model.named_parameters())
    return TrainState(
        params=model, opt=init_adamw(params),
        residuals=init_residuals(params)
        if step_cfg.compress_pod_grads else None,
        rng=seed)


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig, shard=None):
    """``shard``: as `make_train_step`'s."""
    @torch.no_grad()
    def prefill(params, batch):
        with span("serve.prefill"):
            out = transformer.forward(
                params, cfg, batch["tokens"], mode="prefill",
                use_flash=step_cfg.use_flash,
                compute_dtype=step_cfg.compute_dtype,
                frontend_embeds=batch.get("frontend"),
                shard=shard or no_shard)
            return out.logits[:, -1], out.caches

    return prefill


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig, shard=None):
    """The decode step attends through the plain product whatever
    ``use_flash`` says, as the reference's does. ``shard``: as
    `make_train_step`'s."""
    @torch.no_grad()
    def decode(params, batch, caches):
        out = transformer.forward(
            params, cfg, batch["tokens"], mode="decode", caches=caches,
            compute_dtype=step_cfg.compute_dtype, shard=shard or no_shard)
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
