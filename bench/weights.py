"""Inputs made from ``--seed``: every tensor of a layout drawn on the
device into one flat buffer in one call of ``normal_``, then scaled in
place view by view. The same seed gives the same values, so the plain
reference draws the program's weights again without taking anything
from the program."""

from __future__ import annotations

import math
import zlib

#: How a view of the flat buffer is scaled from its standard normal z,
#: by kind: a "matrix" by 1 / sqrt(rows) (its fan-in), a "norm"'s scale
#: to 1 + 0.1 z, the rest by a factor: an embedding table by 0.02, an
#: activation as it is, the executor's weight operands by 0.1 (as
#: `core/executor.py` draws them).
SCALES = {"embed": 0.02, "normal": 1.0, "operand": 0.1}


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each stream of one run's inputs."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % 2 ** 62


def dense_layout(c: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of a dense transformer, by
    the port's parameter names (`models/transformer.py:LM`)."""
    d, h, kv, hd, ff, v = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                           c["head_dim"], c["d_ff"], c["padded_vocab"])
    out = [("embed.table", (v, d), "embed")]
    if not c["tie_embeddings"]:
        out.append(("unembed.table", (v, d), "embed"))
    out.append(("ln_f.scale", (d,), "norm"))
    for i in range(c["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.scale", (d,), "norm"),
                (p + "attn.wq.w", (d, h * hd), "matrix"),
                (p + "attn.wk.w", (d, kv * hd), "matrix"),
                (p + "attn.wv.w", (d, kv * hd), "matrix"),
                (p + "attn.wo.w", (h * hd, d), "matrix"),
                (p + "ln2.scale", (d,), "norm"),
                (p + "mlp.up.w", (d, ff), "matrix"),
                (p + "mlp.down.w", (ff, d), "matrix")]
        if c["gated_mlp"]:
            out.append((p + "mlp.gate.w", (d, ff), "matrix"))
    return out


def numel(shape) -> int:
    return math.prod(shape)


def draw(torch, layout, seed: int, device, tag: str = "weights"):
    """(the flat float32 buffer, {name: view}) of ``layout`` from
    ``seed``."""
    total = sum(numel(s) for _, s, _ in layout)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    flat.normal_(generator=gen)
    views, off = {}, 0
    with torch.no_grad():
        for name, shape, kind in layout:
            n = numel(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if kind == "matrix":
                t.mul_(1.0 / math.sqrt(shape[0]))
            elif kind == "norm":
                t.mul_(0.1).add_(1.0)
            elif SCALES[kind] != 1.0:
                t.mul_(SCALES[kind])
            views[name] = t
    return flat, views


def tokens(torch, seed: int, tag: str, shape, vocab: int, device):
    """Token ids in [0, vocab) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return torch.randint(0, vocab, shape, generator=gen, device=device)
