"""Plain PyTorch versions of the SSD intra-chunk step: the oracle every
kernel launch is checked against and what the wrapper runs on CPU tensors,
plus the sequential recurrence oracle for the whole chunked algorithm.

On CUDA the two products run in full float32: the callers leave
``torch.backends.cuda.matmul.allow_tf32`` at its default, False."""

import torch

NEG_CLIP = -60.0   # exp(-60) is 0 to f32 accuracy; avoids inf - inf NaNs


def ssd_intra_chunk_ref(c, b, s, dt, x):
    """c, b: (B, NC, Q, H, N); s, dt: (B, NC, Q, H); x: (B, NC, Q, H, P)
    -> (B, NC, Q, H, P) in x's dtype, computed in float32:
    ``y[t] = sum_{tau <= t} (C_t . B_tau) exp(max(s_t - s_tau, -60))
    dt_tau x_tau``, with the masked entries (tau > t) exactly 0."""
    sf = s.to(torch.float32)
    seg = sf[:, :, :, None, :] - sf[:, :, None, :, :]      # (B,NC,Q,Q,H)
    q = s.shape[2]
    tri = torch.ones((q, q), dtype=torch.bool, device=s.device).tril()
    decay = torch.where(tri[None, None, :, :, None],
                        torch.exp(torch.clamp_min(seg, NEG_CLIP)), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", c.to(torch.float32),
                          b.to(torch.float32))
    scores = scores * decay * dt.to(torch.float32)[:, :, None, :, :]
    return torch.einsum("bcqkh,bckhp->bcqhp", scores,
                        x.to(torch.float32)).to(x.dtype)


def ssd_sequential_ref(x, dt, a, b, c, d_skip):
    """Step-by-step recurrence oracle for the full SSD layer.
    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N); d_skip:
    (H,) -> (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    bb = torch.repeat_interleave(b, rep, dim=2).to(torch.float32)
    cc = torch.repeat_interleave(c, rep, dim=2).to(torch.float32)
    xf = x.to(torch.float32)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dtt = dt[:, t]
        dec = torch.exp(dtt * a)                               # (B, H)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtt, bb[:, t], xf[:, t])
        state = state * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_skip[None, None, :, None]
    return y.to(x.dtype), state
