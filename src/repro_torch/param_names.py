"""The reference's parameter tree, read from the port's parameter names.

The reference stacks the layers of ``blocks``, ``tail`` and
``enc_blocks`` along a leading axis (``blocks.attn.wq.w`` of shape
(n_layers, d, h*hd)); the port keeps each layer as its own module
(``blocks.<i>.attn.wq.w``). The optimizer and the gradient compression
act on the reference's leaves, so they read them from here: the
compression scales every layer of a stacked leaf as one tensor, and
AdamW decays every leaf of rank >= 2 there.
"""

from __future__ import annotations

import torch

STACKS = ("blocks", "tail", "enc_blocks")


def reference_leaf(name: str) -> str:
    """The leaf of the reference's tree that the parameter ``name`` is
    part of: ``blocks.3.attn.wq.w`` is a slice of ``blocks.attn.wq.w``;
    a name outside the stacks is its own leaf."""
    stack, _, rest = name.partition(".")
    return f"{stack}.{rest.partition('.')[2]}" if stack in STACKS else name


def reference_ndim(name: str, param: torch.Tensor) -> int:
    """The rank of the parameter's leaf in the reference's tree: one more
    inside a layer stack. A per-layer vector in a stack (a norm's scale,
    the SSM's ``a_log``) is a matrix there, and one outside (``ln_f``,
    the hybrid's shared block) is not."""
    return param.ndim + (reference_leaf(name) != name)
