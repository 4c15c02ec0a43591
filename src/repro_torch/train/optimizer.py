"""AdamW and the learning-rate schedules (cosine, MiniCPM's WSD
warmup-stable-decay, constant), hand-rolled on the model's parameters.

The reference keeps its parameters, gradients and moments as pytrees; here
each is a mapping from the model's dotted parameter names to tensors, in
``named_parameters`` order. ``adamw_update`` updates in place, leaf by
leaf under ``torch.no_grad()``: each leaf's float32 temporaries live only
while that leaf is updated, so the step needs no second copy of the
parameters or the moments (at minicpm-2b's published widths one copy of
each is 10.9 GB in float32). ``torch.optim.AdamW`` is not used: its
clip, decay mask and bias correction are not the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.param_names import reference_ndim


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32: updates taken so far
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


# Optimizer-moment storage dtype for float32 parameters (the reference's
# module switch): other parameters keep moments in their own dtype.
OPT_STATE_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | constant
    wsd_stable_frac: float = 0.8      # WSD: fraction of steps at peak LR
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (counted from 1), in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((s - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
            (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # MiniCPM warmup-stable-decay: hold peak LR, then fast 1-cos decay
        stable_end = cfg.wsd_stable_frac
        d = torch.clamp((t - stable_end) / max(1 - stable_end, 1e-6),
                        0.0, 1.0)
        decay = torch.where(t < stable_end, 1.0,
                            cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 *
                            (1 + torch.cos(math.pi * d)))
    else:
        decay = torch.ones_like(t)
    return cfg.lr * warm * decay


def init_adamw(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments beside every parameter, on its device (a ``DTensor``
    parameter's on its placements)."""
    def zeros():
        return {name: torch.zeros_like(
            p, dtype=OPT_STATE_DTYPE if p.dtype == torch.float32
            else p.dtype) for name, p in params.items()}
    device = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(), v=zeros())


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 2-norm over every leaf; over every shard of a
    ``DTensor`` leaf (a ``DTensor`` itself then, replicated)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState):
    """One AdamW step: the gradients clipped to ``grad_clip`` by their
    global norm, bias correction at the new step (from 1, in float32),
    decoupled weight decay on the leaves that are matrices (``ndim >=
    2``) in the reference's tree (`param_names.reference_ndim`: every
    per-layer vector of a layer stack included), the update in float32
    cast back to each leaf's dtype. ``params`` and the moments are
    written in place; returns (params, the new state, ``{"lr",
    "grad_norm"}``)."""
    if set(grads) != set(params) or set(state.m) != set(params):
        raise ValueError("params, grads and moments name different leaves")
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0) \
        if cfg.grad_clip else 1.0
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if reference_ndim(name, p) >= 2:  # decoupled weight decay
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}
