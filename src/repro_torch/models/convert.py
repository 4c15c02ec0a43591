"""Weights carried across: the reference's parameter tree, as numpy
arrays, into the port's model (``params_from_numpy``), and back
(``params_to_numpy``, for the parameters and the AdamW moments of a
train step, to be compared leaf by leaf with the reference's).

The reference keeps each stack of layers along a leading layer axis
(``blocks.attn.wq.w`` of shape (n_layers, d, h*hd)); here each layer is
its own module (``blocks.<i>.attn.wq.w``). The stacks are ``blocks``,
the hybrid's ``tail`` and the encoder-decoder's ``enc_blocks``; each is
split by its own leading axis, which must be the model's count of that
stack (the hybrid's ``blocks`` hold the grouped layers only). A MoE
expert bank keeps its expert axis inside a layer
(``blocks.<i>.moe.experts.up.w`` is (E, D, F)). Values are copied
exactly, in the tree's dtype (bfloat16 included), and a name or shape the
model does not have, or a parameter the tree does not fill, raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LM, init_model
from repro_torch.param_names import STACKS, reference_leaf


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping's leaves under dotted names."""
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` in its own dtype; numpy's bfloat16 (ml_dtypes)
    goes across bit for bit."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def load_numpy(module: nn.Module, flat: Mapping[str, np.ndarray],
               device=None) -> nn.Module:
    """Replace every parameter of ``module`` by the array of its dotted
    name in ``flat``, on ``device`` in the array's dtype. Raises unless
    the names are exactly the module's and every shape matches."""
    want = dict(module.named_parameters())
    unused = sorted(set(flat) - set(want))
    missing = sorted(set(want) - set(flat))
    if unused or missing:
        raise ValueError(f"parameter names differ: not in the model "
                         f"{unused}, not in the tree {missing}")
    for name, param in want.items():
        if tuple(flat[name].shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {flat[name].shape} where the "
                             f"model has {tuple(param.shape)}")
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(
            _to_tensor(np.asarray(flat[name])).to(device),
            requires_grad=False))
    return module


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None) -> LM:
    """``tree``: the reference's ``init_model(key, cfg)`` mapped to numpy
    (``jax.tree.map(np.asarray, params)``). Returns the port's model on
    ``device`` holding those values."""
    model = init_model(cfg, None, device="meta")
    flat = flatten(tree)
    for name in list(flat):
        stack, _, rest = name.partition(".")
        if stack not in STACKS or not hasattr(model, stack):
            continue        # unstacked, or a stack the model lacks: raises
        n = len(getattr(model, stack))
        arr = flat.pop(name)
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"{name}: leading axis {arr.shape[:1]} is not "
                             f"the model's {n} {stack}")
        for i in range(n):
            flat[f"{stack}.{i}.{rest}"] = arr[i]
    return load_numpy(model, flat, device)


def params_to_numpy(cfg: ModelConfig, params) -> dict:
    """The inverse of ``params_from_numpy``: the port's model, or a
    mapping from its dotted parameter names to tensors (the AdamW
    moments), as the reference's nested tree of numpy arrays, each stack
    (``blocks``, ``tail``, ``enc_blocks``) stacked again along a leading
    layer axis. bfloat16 leaves come back as float32 (numpy has no
    bfloat16 of its own), exactly."""
    flat = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else dict(params)
    model = init_model(cfg, None, device="meta")
    if set(flat) != {n for n, _ in model.named_parameters()}:
        raise ValueError(f"not the parameters of {cfg.name}")

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    stacked: dict[str, list] = {}
    tree: dict = {}
    for name, t in flat.items():
        leaf = reference_leaf(name)
        if leaf == name:
            _put(tree, name, host(t))
        else:
            stacked.setdefault(leaf, []).append((int(name.split(".")[1]), t))
    for name, layers in stacked.items():
        layers.sort(key=lambda it: it[0])
        _put(tree, name, np.stack([host(t) for _, t in layers]))
    return tree


def _put(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value
