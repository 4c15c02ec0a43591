"""Fault-tolerant checkpointing of torch state, in the reference's layout
on disk.

Properties kept from the reference (``src/repro/checkpoint``):
  * atomicity — write to ``<dir>/tmp.<step>`` then ``os.replace`` to
    ``step_<n>``; a crash mid-save never corrupts the latest checkpoint,
  * mesh-agnostic restore — arrays are saved in logical (unsharded) layout
    with a manifest,
  * retention — keep the newest ``keep`` checkpoints, delete older,
  * self-describing — a JSON manifest with the step, the leaves' dtypes
    and shapes, and ``extra`` (the data-pipeline cursor is the step).

The layout is the reference's: ``manifest.json`` plus one
``leaf_%05d.npy`` per leaf, in the order ``jax.tree_util`` flattens the
same state in the reference: a NamedTuple's fields in order, a mapping's
(or a module's parameters') leaves in sorted-key order, each parameter
tree in the reference's *stacked* form: the layers of ``blocks`` /
``tail`` / ``enc_blocks`` along a leading axis
(`param_names.reference_leaf`). An integer leaf is a seed, where the
reference holds a key (the port's ``TrainState.rng``): it is written as
the reference's key for that seed (``PRNGKey(seed)``: uint32
``[seed >> 32, seed & 0xffffffff]``) and read back as the seed. So a
``TrainState`` is written as params, ``opt.step``, ``opt.m``,
``opt.v``, ``residuals`` (when present) and ``rng``, the reference's
``load_checkpoint`` reads what this module writes, and this module
reads the reference's. ``None`` has no leaf.

Saving goes leaf by leaf: each layer of a stacked leaf is copied to the
host and written, so the host never holds more than one layer. Loading
reads each layer from its file and copies it into the like-tree's
tensor in place, on its device, and returns that tree (its seeds read
back). Layers on the card pass through one pinned
host buffer as large as the largest of them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.param_names import reference_leaf

_MASK32 = 0xFFFFFFFF


class Leaf(NamedTuple):
    """One leaf of the reference's tree: its name, and the tensors whose
    stack along a new leading axis it is (``stacked``), or the one
    tensor (or, for a key, host array) it is."""
    name: str
    parts: list
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        inner = tuple(self.parts[0].shape)
        return (len(self.parts),) + inner if self.stacked else inner

    @property
    def dtype(self) -> np.dtype:
        t = self.parts[0]
        if isinstance(t, np.ndarray):
            return t.dtype
        if t.dtype == torch.bfloat16:
            raise TypeError(f"{self.name}: bfloat16 has no numpy dtype")
        return torch.empty((), dtype=t.dtype).numpy().dtype


def _named(tree) -> dict[str, torch.Tensor]:
    """A module's parameters, or a mapping's tensors under dotted names."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update({f"{key}.{k}": v for k, v in _named(val).items()})
        else:
            out[str(key)] = val
    return out


def _tree_leaves(named: Mapping[str, torch.Tensor], prefix: str) -> \
        list[Leaf]:
    """The reference's leaves of one parameter-like tree: each stack's
    layers grouped under their stacked name, every leaf in sorted-key
    order (``jax.tree_util``'s order for nested dicts)."""
    groups: dict[str, list[tuple[int, torch.Tensor]]] = {}
    single: dict[str, torch.Tensor] = {}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{prefix}{name}: not a tensor ({type(t)})")
        leaf = reference_leaf(name)
        if leaf == name:
            single[name] = t
        else:
            groups.setdefault(leaf, []).append((int(name.split(".")[1]), t))
    leaves = [Leaf(prefix + n, [t], False) for n, t in single.items()]
    for n, layers in groups.items():
        layers.sort(key=lambda it: it[0])
        if [i for i, _ in layers] != list(range(len(layers))):
            raise ValueError(f"{n}: layers {[i for i, _ in layers]}")
        leaves.append(Leaf(prefix + n, [t for _, t in layers], True))
    return sorted(leaves, key=lambda lf: lf.name[len(prefix):].split("."))


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def reference_leaves(tree, prefix: str = "") -> list[Leaf]:
    """The leaves ``tree`` is written as, in the file order: the
    reference's leaves of the same state, in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, int):                   # a seed, as its key
        return [Leaf(prefix.rstrip("."), [_key_of_seed(tree)], False)]
    if isinstance(tree, torch.Tensor):
        return [Leaf(prefix.rstrip("."), [tree], False)]
    if _is_namedtuple(tree):
        return [lf for name, sub in zip(tree._fields, tree)
                for lf in reference_leaves(sub, f"{prefix}{name}.")]
    if isinstance(tree, (nn.Module, Mapping)):
        return _tree_leaves(_named(tree), prefix)
    raise TypeError(f"{prefix or 'tree'}: cannot checkpoint {type(tree)}")


def _with_seeds(tree, seeds: dict[str, int], prefix: str = ""):
    """``tree`` with each integer leaf replaced by the seed read back
    under its name; every other leaf is kept as it is."""
    if isinstance(tree, int):
        return seeds[prefix.rstrip(".")]
    if _is_namedtuple(tree):
        return type(tree)(*(_with_seeds(sub, seeds, f"{prefix}{name}.")
                            for name, sub in zip(tree._fields, tree)))
    return tree


def _key_of_seed(seed: int) -> np.ndarray:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return np.array([seed >> 32, seed & _MASK32], dtype=np.uint32)


def _seed_of_key(key: np.ndarray) -> int:
    hi, lo = (int(x) for x in np.asarray(key, dtype=np.uint32))
    return (hi << 32) | lo


def _host(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t)
    return t.detach().contiguous().cpu().numpy()


class _Staging:
    """One host buffer that every part on the card passes through on its
    way to or from a file: pinned, so that each copy runs at the host
    link's full rate, and as large as the largest such part."""

    def __init__(self, leaves: list[Leaf]):
        cuda = [t for lf in leaves for t in lf.parts
                if isinstance(t, torch.Tensor) and t.is_cuda]
        n = max((t.numel() * t.element_size() for t in cuda), default=0)
        self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=bool(cuda))

    def bytes_for(self, t, n: int) -> torch.Tensor:
        """``n`` bytes of host memory for a part bound to or from ``t``."""
        if isinstance(t, torch.Tensor) and t.is_cuda and \
                n <= self.buf.numel():
            return self.buf[:n]
        return torch.empty(n, dtype=torch.uint8)


def _write_leaf(path: str, leaf: Leaf, staging: _Staging) -> None:
    """The leaf as one ``.npy`` file, written one part at a time."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": np.lib.format.dtype_to_descr(leaf.dtype),
            "fortran_order": False, "shape": leaf.shape})
        for t in leaf.parts:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                flat = staging.bytes_for(t, t.numel() * t.element_size())
                flat.view(t.dtype).view(t.shape).copy_(t)
                f.write(memoryview(flat.numpy()))
            else:
                _host(t).tofile(f)


def _read_parts(path: str, leaf: Leaf, staging: _Staging):
    """Yield (part, the file's values of that part on the host) for each
    part of ``leaf``, one at a time, in the file's dtype: a tensor, or a
    numpy array for a host-array part."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(f"{path}: .npy version {version}")
        if tuple(shape) != leaf.shape or fortran:
            raise ValueError(f"{leaf.name}: {tuple(shape)} vs {leaf.shape}"
                             f"{' (Fortran order)' if fortran else ''}")
        inner = leaf.shape[1:] if leaf.stacked else leaf.shape
        n = int(np.prod(inner, dtype=np.int64)) * dtype.itemsize
        for t in leaf.parts:
            flat = staging.bytes_for(t, n)
            if f.readinto(memoryview(flat.numpy())) != n:
                raise ValueError(f"{path}: truncated")
            if isinstance(t, np.ndarray):
                yield t, flat.numpy().view(dtype).reshape(inner)
            else:
                want = torch.from_numpy(np.empty(0, dtype)).dtype
                yield t, flat.view(want).view(inner)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None
                    = None, keep: int = 3) -> str:
    """Write ``tree`` as ``<directory>/step_<step>`` (atomically), keep
    the newest ``keep`` checkpoints; returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = reference_leaves(tree)
    staging = _Staging(leaves)
    manifest = {
        "step": step,
        "treedef": f"repro_torch {type(tree).__name__}",
        "n_leaves": len(leaves),
        "extra": extra or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf, staging)
        manifest["leaves"].append({"dtype": str(leaf.dtype),
                                   "shape": list(leaf.shape),
                                   "name": leaf.name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def checkpoint_bytes(directory: str, step: int) -> int:
    """The bytes on disk of the checkpoint of ``step``."""
    path = os.path.join(directory, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def load_checkpoint(directory: str, tree_like, step: int | None = None):
    """Restore into ``tree_like`` (shapes must match), in place: every
    tensor of it gets the checkpoint's values on its own device and in
    its own dtype. Returns (the tree, the step, ``extra``), each
    integer leaf (a seed) replaced by the seed of the stored key."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = reference_leaves(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"leaf count mismatch: {manifest['n_leaves']} vs "
                         f"{len(leaves)}")
    staging = _Staging(leaves)
    seeds = {}
    for i, leaf in enumerate(leaves):
        for t, host in _read_parts(os.path.join(path, f"leaf_{i:05d}.npy"),
                                   leaf, staging):
            if isinstance(t, np.ndarray):       # a seed's key
                seeds[leaf.name] = _seed_of_key(host)
                continue
            with torch.no_grad():
                t.copy_(host)
    return (_with_seeds(tree_like, seeds), manifest["step"],
            manifest.get("extra", {}))


def differing_leaves(directory: str, tree, step: int) -> list[str]:
    """The names of the leaves of ``tree`` that differ from the checkpoint
    of ``step``, compared exactly (``torch.equal``) on each tensor's own
    device, one layer at a time."""
    path = os.path.join(directory, f"step_{step:08d}")
    leaves = reference_leaves(tree)
    staging = _Staging(leaves)
    out = []
    for i, leaf in enumerate(leaves):
        try:
            same = all(
                np.array_equal(host, t) if isinstance(t, np.ndarray) else
                host.dtype == t.dtype and torch.equal(host.to(t.device), t)
                for t, host in _read_parts(
                    os.path.join(path, f"leaf_{i:05d}.npy"), leaf, staging))
        except ValueError:
            same = False
        if not same:
            out.append(leaf.name)
    return out


class CheckpointManager:
    """Step-driven orchestration: periodic saves + crash-safe resume."""

    def __init__(self, directory: str, every: int = 50, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree, extra: dict | None = None):
        if step % self.every == 0 and step > 0:
            return save_checkpoint(self.directory, step, tree, extra,
                                   self.keep)
        return None

    def restore_or_init(self, tree_init):
        step = latest_step(self.directory)
        if step is None:
            return tree_init, 0, {}
        return load_checkpoint(self.directory, tree_init, step)
