"""Training steps back to back through `train/steps.py:make_train_step`.

Set-up builds one train state (the port's model holding the weights drawn
from the seed, zero AdamW moments) and one step function, and drives the
first ``check_steps`` steps through that same call and feed, reading
from the state what the reference follows: each step's loss, each
weight's first clipped gradient (its first moment after one step over
1 - beta1) and each weight's change over the steps. The window then
takes steps on the same object. The feed is ``feed_batches`` batches of
next-token rows drawn from the seed, every row its own.
``train_tokens_per_s``: all tokens of the steps completed over the
window."""

from __future__ import annotations

import time

E2E, UNIT = "train_tokens_per_s", "tokens/s"


def _opt(run) -> dict:
    return run.traffic["optimizer"]


def _feed(torch, run):
    from bench.weights import tokens
    tr, m = run.traffic, run.model
    toks = tokens(torch, run.seed, "feed", (tr["feed_batches"], tr["batch"],
                                             tr["seq"] + 1),
                  m["vocab_size"], run.device)
    return [(toks[i, :, :-1], toks[i, :, 1:]) for i in range(len(toks))]


def setup(run):
    import torch
    from repro_torch.train.optimizer import OptimizerConfig, init_adamw
    from repro_torch.train.steps import StepConfig, TrainState, \
        make_train_step

    from bench.lm import build
    tr, o = run.traffic, _opt(run)
    model, cfg = build(torch, run, copy=True)
    params = dict(model.named_parameters())
    state = TrainState(params=model, opt=init_adamw(params), residuals=None,
                       rng=run.seed)
    opt_cfg = OptimizerConfig(
        lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
        schedule="wsd", wsd_stable_frac=o["stable_frac"],
        min_lr_frac=o["min_lr_frac"])
    step_cfg = StepConfig(microbatches=1, remat=tr["remat"], use_flash=False,
                          compute_dtype=getattr(torch, tr["compute_dtype"]))
    step = make_train_step(cfg, opt_cfg, step_cfg)
    feed = [{"tokens": t, "labels": l} for t, l in _feed(torch, run)]
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, first = [], None
    for k in range(tr["check_steps"]):
        state, met = step(state, feed[k])
        losses.append(met["loss"])
        run.sync()
        run.phase(f"step {k + 1}")
        if k == 0:
            b1 = o["betas"][0]
            first = torch.stack([torch.linalg.vector_norm(state.opt.m[n])
                                 for n in params]) / (1 - b1)
    change = torch.stack([torch.linalg.vector_norm(p - start[n])
                          for n, p in params.items()])
    del start
    names = list(params)
    return {"state": state, "step": step, "feed": feed,
            "next": tr["check_steps"],
            "losses": [float(x) for x in losses],
            "first": dict(zip(names, first.tolist())),
            "change": dict(zip(names, change.tolist()))}


def _take(st):
    st["state"], _ = st["step"](st["state"],
                                st["feed"][st["next"] % len(st["feed"])])
    st["next"] += 1


def window(run, st, seconds):
    tr = run.traffic
    run.sync()
    t0 = time.monotonic()
    n = 0
    while True:
        _take(st)
        n += 1
        if time.monotonic() - t0 >= seconds:
            break
    run.sync()
    elapsed = time.monotonic() - t0
    return {E2E: n * tr["batch"] * tr["seq"] / elapsed}, n, 0


def traced(run, st, prof):
    from bench.peaks import dense_forward_ops
    tr, n = run.traffic, run.traffic["trace_steps"]
    _take(st)
    with prof.window(n):
        for _ in range(n):
            _take(st)
    tokens = tr["batch"] * tr["seq"]
    fwd = dense_forward_ops(run.model, tr["batch"], tr["seq"], tokens)
    return {"steps": n, "train_ops": 3.0 * fwd, "precision": "bf16"}, n, 0


def release(run, st):
    for k in ("state", "step", "feed"):
        st.pop(k, None)


def reference(torch, run, precision: str = "f32", rows=None):
    """The reference's (losses, first clipped gradient norms, changes)
    over the first ``check_steps`` batches of the feed."""
    from bench.lm import reference_weights
    from bench.reference.dense_lm import train_steps
    flat, views = reference_weights(torch, run)
    w = {n: t.clone() for n, t in views.items()}
    del flat, views
    feed = _feed(torch, run)[:run.traffic["check_steps"]]
    out = train_steps(w, run.model, _opt(run), feed, precision, rows)
    del w
    return out


def compare(got, ref) -> dict:
    """Each number by the worst: the loss's relative gap over the steps;
    for the first gradient and the change, the gap of each weight's norm
    against the reference's, over the larger of that weight's reference
    norm and the median weight's. Weights whose reference gradient is
    under a thousandth of the median weight's are left out of the
    change."""
    import statistics

    from bench.harness import worst
    (lp, gp, cp), (lr, gr, cr) = got, ref
    loss = worst(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    gmed = statistics.median(gr.values())
    grad = worst(abs(gp[n] - gr[n]) / max(gr[n], gmed) for n in gr)
    moved = [n for n in cr if gr[n] >= 1e-3 * gmed]
    cmed = statistics.median(cr[n] for n in moved)
    change = worst(abs(cp[n] - cr[n]) / max(cr[n], cmed) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def check(run, st, source: str = "program"):
    """``source`` "control": the reference in fp8 in the program's place;
    "half_batch": the reference on half of each batch's rows."""
    import torch
    ref = reference(torch, run)
    if source == "program":
        got = (st["losses"], st["first"], st["change"])
    elif source == "control":
        got = reference(torch, run, "fp8")
    elif source == "half_batch":
        got = reference(torch, run, rows=slice(0, run.traffic["batch"] // 2))
    else:
        raise ValueError(source)
    return compare(got, ref)
