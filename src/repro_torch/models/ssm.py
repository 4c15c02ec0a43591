"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Prefill uses the chunked SSD algorithm: a quadratic, attention-like
intra-chunk term and an inter-chunk state recurrence (a loop over chunks,
in float32). Decode is the O(1) recurrent update. The intra-chunk product
is what the ssd_scan kernel computes (``ssd_chunked(use_kernel=True)``);
this module also holds its plain form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, RMSNorm, Shard, _param, \
    dense, init_parameters, no_shard, rms_norm, truncated_normal_


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, H, P, N) float32
    conv: torch.Tensor    # (B, K-1, conv_dim)


def ssd_dims(d_model: int, expand: int, head_dim: int, groups: int,
             state: int) -> tuple[int, int, int]:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * groups * state
    return d_inner, n_heads, conv_dim


class Mamba2(nn.Module):
    def __init__(self, d_model: int, *, expand: int, head_dim: int,
                 groups: int, state: int, conv: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        d_inner, n_heads, conv_dim = ssd_dims(d_model, expand, head_dim,
                                              groups, state)
        d_proj = 2 * d_inner + 2 * groups * state + n_heads
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Dense(d_model, d_proj, **kw)
        self.conv_w = _param((conv, conv_dim), dtype, device)
        self.conv_b = _param((conv_dim,), dtype, device)
        self.a_log = _param((n_heads,), torch.float32, device)
        self.dt_bias = _param((n_heads,), torch.float32, device)
        self.d_skip = _param((n_heads,), torch.float32, device)
        self.norm = RMSNorm(d_inner, device=device)
        self.out_proj = Dense(d_inner, d_model, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """This module's own parameters; ``init_parameters`` reaches the
        projections and the norm."""
        truncated_normal_(self.conv_w, 0.1, generator)
        nn.init.zeros_(self.conv_b)
        n_heads = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, n_heads, dtype=torch.float32)))
        nn.init.zeros_(self.dt_bias)
        nn.init.ones_(self.d_skip)


def init_mamba2(generator, d_model: int, *, expand: int, head_dim: int,
                groups: int, state: int, conv: int, dtype=torch.float32,
                device=None) -> Mamba2:
    return init_parameters(
        Mamba2(d_model, expand=expand, head_dim=head_dim, groups=groups,
               state=state, conv=conv, dtype=dtype, device=device),
        generator)


def _split_proj(cfgd: dict, zxbcdt: torch.Tensor):
    d_inner, gn, h = cfgd["d_inner"], cfgd["gn"], cfgd["n_heads"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner * 2 + 2 * gn]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _intra_kernel(cc, bc, s, dtc, xc) -> torch.Tensor:
    """The intra-chunk product on the ssd_scan kernel (its plain version
    on CPU tensors). The kernel takes five operands of one dtype; where
    they differ (bf16 x beside the float32 cumsum) all go in float32, as
    the reference's kernel reads each operand in float32."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    args = (cc, bc, s, dtc, xc)
    if len({t.dtype for t in args}) > 1:
        args = tuple(t.to(torch.float32) for t in args)
    return ssd_intra_chunk(*args)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int = 256, h0: torch.Tensor | None = None,
                use_kernel: bool = False):
    """Chunked SSD.

    x: (B, L, H, P); dt: (B, L, H); a: (H,) (negative);
    b, c: (B, L, G, N); d_skip: (H,).
    Returns (y (B,L,H,P), h_final (B,H,P,N)).
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if l % chunk:
        raise ValueError(f"L {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    # materialised, as jnp.repeat: the kernel reads its operands through
    # their strides, and these then have a unit stride on the head axis
    bc = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtc * a                                    # (B,NC,Q,H), negative
    s = torch.cumsum(da, dim=2)                     # within-chunk cumsum
    # intra-chunk: scores[t, tau] = (C_t . B_tau) exp(s_t - s_tau) dt_tau
    if use_kernel:
        y_intra = _intra_kernel(cc, bc, s, dtc, xc).to(x.dtype)
    else:
        seg = s[:, :, :, None, :] - s[:, :, None, :, :]      # (B,NC,Q,Q,H)
        tri = torch.ones((chunk, chunk), dtype=torch.bool,
                         device=x.device).tril()
        # masked before the exp: above the diagonal seg is positive and
        # its exp overflows to inf within a few dozen steps; the
        # reference's where(tri, exp(seg), 0) has the same values but a
        # gradient of 0 * inf = NaN there (ROADMAP Queue C)
        decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                      float("-inf")))
        scores = torch.einsum("bcqhn,bckhn->bcqkh", cc.to(torch.float32),
                              bc.to(torch.float32))
        scores = scores * decay * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores.to(x.dtype), xc)

    # chunk summary state: S = sum_tau exp(s_Q - s_tau) dt_tau B_tau x_tau^T
    tail = s[:, :, -1:, :] - s                                  # (B,NC,Q,H)
    w = (torch.exp(tail) * dtc).to(x.dtype)
    s_chunk = torch.einsum("bcqhn,bcqhp->bchpn", bc * w[..., None], xc)

    # inter-chunk recurrence over the chunk index, in float32
    chunk_decay = torch.exp(s[:, :, -1, :])                     # (B,NC,H)
    hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=x.device) if h0 is None else h0
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, ci, :, None, None] + \
            s_chunk[:, ci].to(torch.float32)
    h_prevs = torch.stack(h_prevs, dim=1)                       # (B,NC,H,P,N)

    # inter-chunk contribution: y_t += (C_t . h_prev) * exp(s_t)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           (cc * torch.exp(s)[..., None]).to(x.dtype),
                           h_prevs.to(x.dtype))
    y = y_intra + y_inter + \
        xc * d_skip[None, None, None, :, None].to(x.dtype)
    return y.reshape(bsz, l, h, p), hprev


def ssd_recurrent_step(x, dt, a, b, c, d_skip, h):
    """O(1) decode update. x:(B,H,P) dt:(B,H) b,c:(B,G,N) h:(B,H,P,N)."""
    nh = x.shape[1]
    rep = nh // b.shape[1]
    bb = b.repeat_interleave(rep, dim=1)            # (B,H,N)
    cc = c.repeat_interleave(rep, dim=1)
    dec = torch.exp(dt * a)                         # (B,H)
    upd = (dt[:, :, None, None] * x[:, :, :, None]) * bb[:, :, None, :]
    h_new = h * dec[:, :, None, None] + upd.to(torch.float32)
    y = torch.einsum("bhpn,bhn->bhp", h_new.to(x.dtype), cc)
    return y + x * d_skip[None, :, None].to(x.dtype), h_new


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv over seq. xbc: (B, L, C); w: (K, C).
    Returns (out, new_conv_state=(B, K-1, C))."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    l = xbc.shape[1]
    out = sum(xp[:, i:i + l, :] * w[i][None, None, :].to(xbc.dtype)
              for i in range(k))
    out = out + bias[None, None, :].to(xbc.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(out), new_state


def ssd_inputs(params: Mamba2, x: torch.Tensor, cfg,
               conv_state: torch.Tensor | None = None,
               shard: Shard = no_shard):
    """The block's projection and conv, up to the SSD's operands:
    returns ``(z, xs (B,L,H,P), dt (B,L,H) f32, a (H,), b, c (B,L,G,N),
    new_conv_state)``."""
    d_inner, n_heads, _ = ssd_dims(x.shape[-1], cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_groups,
                                   cfg.ssm_state)
    gn = cfg.ssm_groups * cfg.ssm_state
    meta = {"d_inner": d_inner, "gn": gn, "n_heads": n_heads}
    bsz, l, _ = x.shape
    z, xbc, dt = _split_proj(meta, dense(params.in_proj, x, shard))
    dt = F.softplus(dt.to(torch.float32) + params.dt_bias)
    a = -torch.exp(params.a_log)                    # (H,) negative
    xbc, new_conv = _causal_conv(xbc, params.conv_w, params.conv_b,
                                 conv_state)
    xs = xbc[..., :d_inner].reshape(bsz, l, n_heads, cfg.ssm_head_dim)
    bmat = xbc[..., d_inner:d_inner + gn].reshape(
        bsz, l, cfg.ssm_groups, cfg.ssm_state)
    cmat = xbc[..., d_inner + gn:].reshape(
        bsz, l, cfg.ssm_groups, cfg.ssm_state)
    return z, xs, dt, a, bmat, cmat, new_conv


def mamba2_block(params: Mamba2, x: torch.Tensor, cfg, *,
                 state: SSMState | None = None, chunk: int = 256,
                 use_kernel: bool = False, shard: Shard = no_shard):
    """x: (B, L, D) (prefill) or (B, 1, D) with state (decode).
    Returns (out, new_state)."""
    bsz, l, _ = x.shape
    decode = state is not None and l == 1
    z, xs, dt, a, bmat, cmat, new_conv = ssd_inputs(
        params, x, cfg, state.conv if state is not None else None, shard)
    xs = shard("ssm_x", xs)
    if decode:
        # on a mesh each rank's batch rows, every head: DTensor would fold
        # the batch and head axes into one for its batched product
        args = (xs[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0],
                params.d_skip, state.h)
        y, h_new = shard.on_batch(ssd_recurrent_step, args[0], args,
                                  (0, 0, None, 0, 0, None, 0), (0, 0))
        y = y[:, None]
    else:
        h0 = state.h if state is not None else None
        pad_to = (-l) % chunk
        if pad_to:
            padc = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad_to))
            xs, dt = padc(xs), padc(dt)
            bmat, cmat = padc(bmat), padc(cmat)
        ssd = functools.partial(ssd_chunked, chunk=min(chunk, xs.shape[1]),
                                use_kernel=use_kernel)
        # as the decode step's: each rank's batch rows, every head, the
        # whole sequence (the chunks' recurrence runs along it)
        args = (xs, dt, a, bmat, cmat, params.d_skip, h0)
        y, h_new = shard.on_batch(lambda *t: ssd(*t[:6], h0=t[6]), xs, args,
                                  (0, 0, None, 0, 0, None, 0), (0, 0))
        y = y[:, :l]
    y = y.reshape(bsz, l, -1)
    y = rms_norm(params.norm, y * F.silu(z.to(y.dtype)))
    out = dense(params.out_proj, y, shard)
    return out, SSMState(h=h_new, conv=new_conv)


def init_ssm_state(batch: int, cfg, d_model: int, dtype=torch.float32,
                   device=None) -> SSMState:
    _, n_heads, conv_dim = ssd_dims(d_model, cfg.ssm_expand,
                                    cfg.ssm_head_dim, cfg.ssm_groups,
                                    cfg.ssm_state)
    return SSMState(
        h=torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device))
