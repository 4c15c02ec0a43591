"""A batch of chat sessions decoded greedily, step after step.

Set-up prefills ``batch`` prompts of ``prompt_len`` tokens drawn from the
seed with `train/steps.py:make_prefill_step` (in groups of
``prefill_group``), joins their caches and pads them to ``max_seq``
positions (`serve_lm.pad_caches`): the cache the traffic needs. Each
session's first token comes from the prefill. In the window,
`make_decode_step` runs back to back with each step's greedy tokens fed
to the next, in rounds of ``gen_len`` steps: a round serves every
session ``gen_len`` more tokens, and the next round starts again from
the prefilled caches. A CUDA event after each step marks when its tokens
exist; ``itl_ms_p95`` is the 95th percentile of the gaps between
consecutive marks, every step of the window. A round still running when
the window closes is finished after it, untimed, so that the check has
whole requests.

The check takes ``sample_requests`` sessions drawn from the seed, runs
the reference over each prompt with its served tokens, and reads the
widest gap by which a served token's logit lies below the reference's
best at its position."""

from __future__ import annotations

import time

E2E, UNIT = "itl_ms_p95", "ms"


def _prompts(torch, run):
    from bench.weights import tokens
    tr = run.traffic
    return tokens(torch, run.seed, "prompts", (tr["batch"], tr["prompt_len"]),
                  run.model["vocab_size"], run.device)


def setup(run):
    import torch
    from repro_torch.serve_lm import pad_caches
    from repro_torch.train.steps import StepConfig, make_decode_step, \
        make_prefill_step

    from bench.lm import build
    tr = run.traffic
    model, cfg = build(torch, run, copy=False)
    step_cfg = StepConfig(use_flash=True, compute_dtype=torch.float32)
    prefill = make_prefill_step(cfg, step_cfg)
    decode = make_decode_step(cfg, step_cfg)
    prompts = _prompts(torch, run)
    firsts, parts = [], []
    for b0 in range(0, tr["batch"], tr["prefill_group"]):
        logits, caches = prefill(model, {"tokens":
                                         prompts[b0:b0 + tr["prefill_group"]]})
        firsts.append(torch.argmax(logits, dim=-1))
        parts.append(caches)
        del logits
    caches = type(parts[0])(*(None if ts[0] is None else torch.cat(ts, dim=1)
                              for ts in zip(*parts)))
    del parts
    run.sync()
    run.phase("prompts prefilled")
    origin = pad_caches(caches, tr["max_seq"], cfg.family)
    del caches
    first = torch.cat(firsts)[:, None]
    st = {"model": model, "decode": decode, "origin": origin,
          "first": first, "rounds": [], "round": [first], "cache": origin}
    for _ in range(2):                  # warm: the step's shapes
        decode(model, {"tokens": first}, origin)
    run.sync()
    return st


def _take(st, gen_len: int) -> None:
    """One decode step of the current round; a round of ``gen_len``
    steps that completes is kept and the next starts from the prefill."""
    logits, st["cache"] = st["decode"](st["model"],
                                       {"tokens": st["round"][-1]},
                                       st["cache"])
    st["round"].append(logits.argmax(dim=-1)[:, None])
    if len(st["round"]) == gen_len + 1:
        st["rounds"].append(st["round"])
        st["last_logits"] = logits
        st["round"], st["cache"] = [st["first"]], st["origin"]


def _finish_round(run, st) -> None:
    """Drive the round in flight to its end, after the window."""
    g = run.traffic["gen_len"]
    while not st["rounds"]:
        _take(st, g)


def window(run, st, seconds):
    import torch

    from bench.harness import Stamps, percentile
    g = run.traffic["gen_len"]
    stamps = Stamps(torch, run.on_card)
    run.sync()
    t0 = time.monotonic()
    stamps.mark()
    n = 0
    while True:
        _take(st, g)
        stamps.mark()
        n += 1
        if time.monotonic() - t0 >= seconds:
            break
    run.sync()
    gaps = stamps.gaps_ms()
    return {E2E: percentile(gaps, 0.95)}, n * run.traffic["batch"], 0


def traced(run, st, prof):
    n = run.traffic["trace_steps"]
    g = run.traffic["gen_len"]
    _take(st, g)
    with prof.window(n):
        for _ in range(n):
            _take(st, g)
    return {"steps": n}, n * run.traffic["batch"], 0


def release(run, st):
    import torch
    _finish_round(run, st)
    st["served"] = torch.cat(st["rounds"][-1], dim=1)   # (B, gen_len + 1)
    st["last"] = st.pop("last_logits")      # the round's last step, (B, V)
    for k in ("model", "decode", "origin", "cache", "rounds", "round"):
        st.pop(k, None)


def check(run, st, source: str = "program"):
    """``token_gap``: the widest gap of a served token below the
    reference's best logit at its position; ``logits_err``: the widest
    error of a sampled request's logits at the round's last step
    relative to the reference's (2-norms). ``source`` "control": the
    reference in TF32 in the program's place, its gap read at every
    position of the same prompts and tokens."""
    import random

    import torch

    from bench.harness import worst
    from bench.lm import reference_weights
    from bench.reference.dense_lm import head, hidden
    tr = run.traffic
    flat, w = reference_weights(torch, run)
    prompts = _prompts(torch, run)
    served = st["served"].to(prompts.device)
    rows = random.Random(run.seed).sample(range(tr["batch"]),
                                          tr["sample_requests"])
    p = tr["prompt_len"]
    gap = err = 0.0
    with torch.no_grad():
        for r in rows:
            seq = torch.cat([prompts[r], served[r, :-1]])[None]
            ref = head(w, run.model, hidden(w, run.model, seq))[0]
            if source == "control":
                low = head(w, run.model, hidden(w, run.model, seq, "tf32"),
                           "tf32")[0]
                pick, last = low.argmax(dim=-1), low[-1]
            else:
                ref = ref[p - 1:]
                pick, last = served[r], st["last"][r].to(ref.device)
            g = ref.max(dim=-1).values - ref.gather(-1, pick[:, None])[:, 0]
            e = float(torch.linalg.vector_norm(last - ref[-1]) /
                      torch.linalg.vector_norm(ref[-1]))
            gap, err = worst([gap, float(g.max())]), worst([err, e])
    del flat, w
    return {"token_gap": gap, "logits_err": err}
