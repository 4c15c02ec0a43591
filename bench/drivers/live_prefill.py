"""Prompt processing for long documents: a closed loop of one client.

Each request batch is ``batch`` prompts of one length; the schedule holds
every length of ``lengths`` ``repeats`` times, in an order drawn from the
seed, so every seed does the same work. The client sends a batch, the
port prefills it with `train/steps.py:make_prefill_step` (the flash
prefill on, float32, TF32 off), takes the greedy first token of each
prompt back to the host, and sends the next, cycling through the
schedule until the window closes. ``ttft_ms_p95``: the 95th percentile
over every request of the window of the time from its batch's send to
its first token on the host.

The check takes ``sample_batches`` schedule slots (the longest among
them), runs the reference over each prompt, and reads the widest gap by
which a served token's logit lies below the reference's best and the
served last-position logits' error relative to the reference's."""

from __future__ import annotations

import time

E2E, UNIT = "ttft_ms_p95", "ms"


def schedule(run) -> list[int]:
    """The prompt length of each slot of the cycle."""
    import random
    tr = run.traffic
    order = list(tr["lengths"]) * tr["repeats"]
    random.Random(run.seed).shuffle(order)
    return order


def _prompt(torch, run, slot: int, length: int):
    from bench.weights import tokens
    return tokens(torch, run.seed, f"prompt.{slot}",
                  (run.traffic["batch"], length), run.model["vocab_size"],
                  run.device)


def setup(run):
    import torch
    from repro_torch.train.steps import StepConfig, make_prefill_step

    from bench.lm import build
    model, cfg = build(torch, run, copy=False)
    prefill = make_prefill_step(cfg, StepConfig(use_flash=True,
                                                compute_dtype=torch.float32))
    order = schedule(run)
    prompts = [_prompt(torch, run, k, n) for k, n in enumerate(order)]
    st = {"model": model, "prefill": prefill, "order": order,
          "prompts": prompts, "served": {}, "next": 0}
    warmed = set()
    for k, n in enumerate(order):       # warm: each length once
        if n not in warmed:
            prefill(model, {"tokens": prompts[k]})
            warmed.add(n)
    run.sync()
    return st


def _send(st) -> float:
    """One batch, sent and answered: its time to first token in s."""
    k = st["next"] % len(st["order"])
    st["next"] += 1
    t0 = time.monotonic()
    logits, _ = st["prefill"](st["model"], {"tokens": st["prompts"][k]})
    tok = logits.argmax(dim=-1).cpu()
    t = time.monotonic() - t0
    # the last-position rows alone: the prefill's logits are a view of
    # every position's
    st["served"][k] = (tok, logits.clone())
    return t


def window(run, st, seconds):
    from bench.harness import percentile
    b = run.traffic["batch"]
    run.sync()
    t0 = time.monotonic()
    ttft = []
    while True:
        ttft += [_send(st) * 1e3] * b
        if time.monotonic() - t0 >= seconds:
            break
    return {E2E: percentile(ttft, 0.95)}, len(ttft), 0


def traced(run, st, prof):
    from bench.peaks import dense_forward_ops
    n, m, b = len(st["order"]), run.model, run.traffic["batch"]
    with prof.window(n):
        for _ in range(n):
            _send(st)
    lengths = [st["order"][k % n] for k in range(st["next"] - n,
                                                 st["next"])]
    return {"steps": n, "precision": "f32",
            "prefill_ops": sum(dense_forward_ops(m, b, l, b)
                               for l in lengths),
            "flash_prefill": [(b, l, m["n_heads"], m["head_dim"])
                              for l in lengths for _ in
                              range(m["n_layers"])]}, n * b, 0


def release(run, st):
    for k in ("model", "prefill", "prompts"):
        st.pop(k, None)


def check(run, st, source: str = "program"):
    """``token_gap``: the widest gap of a served token below the
    reference's best logit; ``logits_err``: the widest error of a served
    last-position logit row relative to the reference's row (2-norms).
    ``source`` "control": the reference in TF32 in the program's place,
    its gap read at every position of the prompts."""
    import random

    import torch

    from bench.harness import worst
    from bench.lm import reference_weights
    from bench.reference.dense_lm import head, hidden
    tr, m = run.traffic, run.model
    slots = sorted(st["served"])
    longest = max(slots, key=lambda k: st["order"][k])
    rng = random.Random(run.seed)
    rest = [k for k in slots if k != longest]
    pick = [longest] + rng.sample(rest, min(len(rest),
                                            tr["sample_batches"] - 1))
    flat, w = reference_weights(torch, run)
    gap = err = 0.0
    with torch.no_grad():
        for k in pick:
            prompt = _prompt(torch, run, k, st["order"][k])
            tok, got = st["served"][k]
            for r in range(tr["batch"]):
                x = hidden(w, m, prompt[r:r + 1])[0]
                if source == "control":
                    ref = head(w, m, x)
                    low = head(w, m, hidden(w, m, prompt[r:r + 1], "tf32")[0],
                               "tf32")
                    g = ref.max(dim=-1).values - \
                        ref.gather(-1, low.argmax(dim=-1)[:, None])[:, 0]
                    row, last = ref[-1], low[-1]
                else:
                    row = head(w, m, x[-1:])[0]
                    g = row.max() - row[int(tok[r])]
                    last = got[r].to(row.device)
                e = float(torch.linalg.vector_norm(last - row) /
                          torch.linalg.vector_norm(row))
                gap, err = worst([gap, float(g.max())]), worst([err, e])
    del flat, w
    return {"token_gap": gap, "logits_err": err}
