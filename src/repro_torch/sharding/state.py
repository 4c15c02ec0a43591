"""The train state on a mesh: every parameter, both AdamW moments and the
compression's residuals as ``DTensor``s with the plan's placements
(`rules.ShardingPlan.param_spec_for` of the parameter), the step count
and the seed as they are.

`init_sharded_train_state` is `train.steps.init_train_state` with a
``place`` hook: the model is drawn one module at a time, as on one
device, and each parameter is placed on the mesh as soon as its module
is drawn, so the plain copy of the whole model never exists beside the
sharded one (at minicpm-2b's published widths that copy is 10.9 GB).
Every rank draws the same values and keeps its own shards
(``src_data_rank=None``: no scatter). The values are those of the
one-device state bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch
from torch import nn

from repro_torch.sharding.rules import ShardingPlan, is_dtensor, mesh_axes, \
    microbatch_rows, placements, sanitize, spec_axes


def place(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``t`` (the same on every rank) as a ``DTensor`` on ``mesh`` with
    the placements of ``spec``: each rank keeps its own shards."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                             src_data_rank=None)


def place_batch(t: torch.Tensor, plan: ShardingPlan,
                microbatches: int = 1) -> torch.Tensor:
    """A batch tensor (the same on every rank) on the plan's mesh: of rank
    >= 2 on its batch spec (each axis that does not divide its dim
    dropped, `rules.sanitize`), else replicated. With ``microbatches`` =
    mb > 1 and its rows split over n ranks with B a multiple of mb * n,
    the rows are first put in `rules.microbatch_rows`' order, so that
    each rank's i-th local chunk is its share of the reference's
    microbatch i (`rules.local_microbatches`)."""
    spec = sanitize(plan.batch_spec(), t.shape, plan.mesh) \
        if t.ndim >= 2 else ()
    ranks = math.prod(mesh_axes(plan.mesh)[a]
                      for a in spec_axes(spec[0])) if spec else 1
    if microbatches > 1 and ranks > 1 and \
            t.shape[0] % (microbatches * ranks) == 0:
        t = microbatch_rows(t, microbatches, ranks)
    return place(t, plan.mesh, spec)


def _param_name(name: str) -> str:
    """The parameter a state tensor belongs to: ``opt.m.blocks.0.attn.wq.w``
    and ``params.blocks.0.attn.wq.w`` both to ``blocks.0.attn.wq.w``."""
    for prefix in ("params.", "opt.m.", "opt.v.", "residuals."):
        if name.startswith(prefix):
            return name[len(prefix):]
    return ""


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """Where each tensor of a ``TrainState`` lies on ``mesh``, by its
    dotted name in the state: a parameter, its moments and its residual
    take the parameter's spec under ``plan``; the step count (and
    anything else) has none and stays as it is. `distribute_state` and
    `checkpoint.load_checkpoint` read it."""
    plan: ShardingPlan
    mesh: object

    def spec(self, name: str, t: torch.Tensor):
        param = _param_name(name)
        return self.plan.param_spec_for(param, t) if param else None


def map_state(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each tensor ``t`` at dotted name ``n`` replaced by
    ``fn(n, t)``: a module's parameters in place, one at a time (so the
    old one can be freed before the next is made), a mapping's values, a
    NamedTuple's fields and a tuple's items (named by index) in new
    containers; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix.rstrip("."), tree)
    if isinstance(tree, nn.Module):
        # by name: a list of the parameters themselves would keep every
        # replaced one alive to the end
        for name in [n for n, _ in tree.named_parameters()]:
            owner, _, attr = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            p = getattr(mod, attr)
            new = fn(prefix + name, p)
            if new is not p:
                setattr(mod, attr, nn.Parameter(new, requires_grad=False))
            del p, new
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(sub, fn, f"{prefix}{field}.")
                            for field, sub in zip(tree._fields, tree)))
    if isinstance(tree, tuple):
        return tuple(map_state(sub, fn, f"{prefix}{i}.")
                     for i, sub in enumerate(tree))
    if isinstance(tree, Mapping):
        return {k: map_state(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    return tree


def distribute_state(tree, shardings: StateShardings):
    """Every plain tensor of ``tree`` that ``shardings`` gives a spec
    placed on its mesh (`place`), tensor by tensor; ``DTensor``s and
    tensors without a spec as they are."""
    def fn(name, t):
        spec = None if is_dtensor(t) else shardings.spec(name, t)
        return t if spec is None else place(t, shardings.mesh, spec)
    return map_state(tree, fn)


def init_sharded_train_state(seed: int, cfg, step_cfg, plan: ShardingPlan,
                             mesh, param_dtype=torch.float32, device=None):
    """`train.steps.init_train_state` on ``mesh``: each parameter placed
    by ``plan`` as soon as it is drawn, the moments and residuals beside
    it (see the module docstring)."""
    from repro_torch.train.steps import init_train_state
    return init_train_state(
        seed, cfg, step_cfg, param_dtype, device,
        place=lambda name, p: place(p, mesh, plan.param_spec_for(name, p)))
