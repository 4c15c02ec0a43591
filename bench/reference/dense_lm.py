"""Plain reference of the dense transformer the configurations describe:
token embedding, pre-norm blocks of RMSNorm, attention with RoPE over
grouped K/V heads, a gated SiLU MLP, the final RMSNorm and the LM head
(the embedding table again when tied), the mean next-token
cross-entropy, its backward pass by autograd, and AdamW under the
warmup-stable-decay schedule. Weights are a ``{name: tensor}`` mapping
under the names of `bench/weights.py:dense_layout`; the configuration is
the cell's JSON file's ``model`` section."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.ops import attention
from bench.reference.precision import matmul


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, positions, theta):
    """Rotate each head's two halves by position times the frequencies
    theta ** (-2i / hd); x: (B, L, H, hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = positions[:, None].to(torch.float32) * freqs       # (L, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def block(w: dict, c: dict, i: int, x, precision: str):
    p = f"blocks.{i}."
    b, l, _ = x.shape
    h, kv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    mm = lambda a, name: matmul(a, w[p + name], precision)
    hx = rms_norm(x, w[p + "ln1.scale"], c["norm_eps"])
    pos = torch.arange(l, device=x.device)
    q = rope(mm(hx, "attn.wq.w").view(b, l, h, hd), pos, c["rope_theta"])
    k = rope(mm(hx, "attn.wk.w").view(b, l, kv, hd), pos, c["rope_theta"])
    v = mm(hx, "attn.wv.w").view(b, l, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    o = attention(q, k, v, causal=True, precision=precision)
    x = x + mm(o.reshape(b, l, h * hd), "attn.wo.w")
    hx = rms_norm(x, w[p + "ln2.scale"], c["norm_eps"])
    up = mm(hx, "mlp.up.w")
    if c["gated_mlp"]:
        up = F.silu(mm(hx, "mlp.gate.w")) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return x + mm(up, "mlp.down.w")


def hidden(w: dict, c: dict, tokens, precision: str = "f32",
           remat: bool = False):
    """The final normed hidden states (B, L, d) of ``tokens`` (B, L)."""
    x = w["embed.table"][tokens].to(torch.float32)
    for i in range(c["n_layers"]):
        if remat:
            x = checkpoint(block, w, c, i, x, precision, use_reentrant=False)
        else:
            x = block(w, c, i, x, precision)
    return rms_norm(x, w["ln_f.scale"], c["norm_eps"])


def head(w: dict, c: dict, x, precision: str = "f32"):
    table = w["embed.table"] if c["tie_embeddings"] else w["unembed.table"]
    return matmul(x, table.T, precision)


def logits(w: dict, c: dict, tokens, precision: str = "f32"):
    """Logits at every position, (B, L, padded vocab) float32."""
    return head(w, c, hidden(w, c, tokens, precision), precision)


def loss(w: dict, c: dict, tokens, labels, precision: str = "f32",
         remat: bool = True):
    """The mean cross-entropy of ``labels`` under the logits of
    ``tokens``, both (B, L)."""
    lg = head(w, c, hidden(w, c, tokens, precision, remat), precision)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


def wsd_lr(o: dict, step: int) -> float:
    """The warmup-stable-decay rate at ``step`` (from 1): linear warmup
    over ``warmup_steps``, the peak up to ``stable_frac`` of the steps
    after it, then a cosine down to ``min_lr_frac`` of the peak."""
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    t = min(max((step - o["warmup_steps"]) /
                max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    if t < o["stable_frac"]:
        decay = 1.0
    else:
        d = min(max((t - o["stable_frac"]) / max(1 - o["stable_frac"], 1e-6),
                    0.0), 1.0)
        decay = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * \
            (1 + math.cos(math.pi * d))
    return o["lr"] * warm * decay


def decayed(name: str, t: torch.Tensor) -> bool:
    """Weight decay takes the matrices and every per-layer vector of the
    blocks (a matrix once the layers are stacked), not the final norm."""
    return t.ndim >= 2 or name.startswith("blocks.")


@torch.no_grad()
def adamw(o: dict, w: dict, grads: dict, m: dict, v: dict, step: int):
    """One AdamW step in place: the gradients clipped to ``grad_clip`` by
    their global norm, bias correction at ``step``, decoupled weight
    decay on the `decayed` leaves."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp_max(o["grad_clip"] / (gnorm + 1e-9), 1.0)
    b1, b2 = o["betas"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    lr = wsd_lr(o, step)
    for name, p in w.items():
        g = grads[name] * scale
        m[name].mul_(b1).add_((1 - b1) * g)
        v[name].mul_(b2).add_((1 - b2) * g * g)
        delta = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + o["eps"])
        if decayed(name, p):
            delta = delta + o["weight_decay"] * p
        p.sub_(lr * delta)


def train_steps(w: dict, c: dict, o: dict, batches, precision: str = "f32",
                rows=None):
    """Train ``w`` (float32 leaves, updated in place) on ``batches``, a
    list of (tokens, labels), one AdamW step each (``rows``: the batch
    rows the loss takes, all when None). Returns (the loss of each step,
    {name: the first step's clipped gradient norm}, {name: the norm of
    each weight's change over the steps})."""
    start = {n: t.clone() for n, t in w.items()}
    m = {n: torch.zeros_like(t) for n, t in w.items()}
    v = {n: torch.zeros_like(t) for n, t in w.items()}
    losses, first = [], None
    for step, (tok, lab) in enumerate(batches, 1):
        if rows is not None:
            tok, lab = tok[rows], lab[rows]
        for t in w.values():
            t.requires_grad_(True)
        total = loss(w, c, tok, lab, precision)
        g = torch.autograd.grad(total, list(w.values()))
        for t in w.values():
            t.requires_grad_(False)
        grads = dict(zip(w, g))
        del g
        losses.append(float(total.detach()))
        if first is None:
            gnorm = torch.sqrt(sum(torch.sum(t * t) for t in grads.values()))
            scale = min(o["grad_clip"] / (float(gnorm) + 1e-9), 1.0)
            first = {n: float(torch.linalg.vector_norm(t)) * scale
                     for n, t in grads.items()}
        adamw(o, w, grads, m, v, step)
        del grads, total
    change = {n: float(torch.linalg.vector_norm(w[n] - start[n]))
              for n in w}
    return losses, first, change
