"""The plain references against the port at the test sizes on the CPU:
the int8 product and attention against the kernels' plain versions, the
dense LM's forward against the port's prefill and decode, and its three
train steps against the port's train step, on the same weights (the
harness's draw, installed in the port's model)."""

import pytest
import torch

from bench import lm
from bench.reference import dense_lm, ops


@pytest.mark.parametrize("m,k,n", [(4, 64, 32), (128, 64, 2048), (3, 5, 7)])
def test_quantized_matmul_is_the_ports(m, k, n):
    from repro_torch.kernels.matmul_int8.ops import quantized_matmul
    g = torch.Generator().manual_seed(m * k * n)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g) * 0.1
    got = quantized_matmul(x, w, out_dtype=torch.float32)
    assert torch.equal(got, ops.quantized_matmul(x, w))
    four = ops.quantized_matmul(x, w, bits=4)
    assert float((four - got).abs().max()) > 1e-3 * float(got.abs().max())


@pytest.mark.parametrize("causal,lq,lk", [(True, 9, 9), (False, 1, 40),
                                          (True, 5, 5)])
def test_attention_is_the_ports(causal, lq, lk):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(lq + lk)
    q = torch.randn(2, lq, 3, 16, generator=g)
    k, v = (torch.randn(2, lk, 3, 16, generator=g) for _ in range(2))
    want = attention_ref(q, k, v, causal=causal)
    got = ops.attention(q, k, v, causal=causal, block=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["glm4-9b.serve-decode-b32",
                                  "minicpm-2b.serve-prefill-b4"])
def test_forward_is_the_ports(cell, tiny_run, one_thread):
    from repro_torch.models.transformer import forward
    run = tiny_run(cell)
    model, cfg = lm.build(torch, run, copy=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    out = forward(model, cfg, toks, mode="prefill",
                  compute_dtype=torch.float32)
    _, w = lm.reference_weights(torch, run)
    ref = dense_lm.logits(w, run.model, toks)
    torch.testing.assert_close(out.logits, ref, rtol=1e-4, atol=1e-5)


def test_decode_is_the_full_forward(tiny_run, one_thread):
    from repro_torch.serve_lm import pad_caches
    from repro_torch.train.steps import StepConfig, make_decode_step, \
        make_prefill_step
    run = tiny_run("glm4-9b.serve-decode-b32")
    model, cfg = lm.build(torch, run, copy=False)
    sc = StepConfig(compute_dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(4))
    logits, caches = make_prefill_step(cfg, sc)(model, {"tokens": toks[:,
                                                                      :6]})
    caches = pad_caches(caches, 12, cfg.family)
    decode, got = make_decode_step(cfg, sc), [logits]
    for j in range(6, 10):
        logits, caches = decode(model, {"tokens": toks[:, j:j + 1]}, caches)
        got.append(logits)
    _, w = lm.reference_weights(torch, run)
    ref = dense_lm.logits(w, run.model, toks)[:, 5:]
    torch.testing.assert_close(torch.stack(got, 1), ref, rtol=1e-4,
                               atol=1e-5)


def test_train_steps_are_the_ports(tiny_run, one_thread):
    """Three float32 steps of the port's train step (remat on) against
    the reference's: each loss, each weight's first clipped gradient norm
    and its change."""
    from repro_torch.train.optimizer import OptimizerConfig, init_adamw
    from repro_torch.train.steps import StepConfig, TrainState, \
        make_train_step

    from bench.drivers import train as drv
    run = tiny_run("minicpm-2b.train-4x1024")
    o = run.traffic["optimizer"]
    model, cfg = lm.build(torch, run, copy=True)
    params = dict(model.named_parameters())
    state = TrainState(model, init_adamw(params), None, 0)
    step = make_train_step(cfg, OptimizerConfig(
        lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
        schedule="wsd", wsd_stable_frac=o["stable_frac"],
        min_lr_frac=o["min_lr_frac"]),
        StepConfig(remat=True, compute_dtype=torch.float32))
    start = {n: p.clone() for n, p in params.items()}
    feed = drv._feed(torch, run)[:3]
    losses, first = [], None
    for k, (t, l) in enumerate(feed):
        state, met = step(state, {"tokens": t, "labels": l})
        losses.append(float(met["loss"]))
        if k == 0:
            first = {n: float(state.opt.m[n].norm()) / (1 - o["betas"][0])
                     for n in params}
    change = {n: float((p - start[n]).norm()) for n, p in params.items()}
    gaps = drv.compare((losses, first, change), drv.reference(torch, run))
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-4, gaps
