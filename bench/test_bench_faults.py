"""Each cell's check against a program broken underneath: the harness's
look for a chip skipped, the rest of a run driven at the test sizes on
the CPU with the limits of the cell's file. A sound run comes out
correct; each fault the cell can have comes out not correct: a step
that leaves its state (or its output) as it was, half of the batch left
out, a token or an answer altered where it is produced. (No cell spans
chips, so no exchange between chips can be left out.)"""

import pytest
import torch

from bench import harness


def _run(tiny_run, cell, **kw):
    return harness.run_cell(tiny_run(cell, **kw))


@pytest.mark.parametrize("cell", ["glm4-9b.exec-decode32k",
                                  "minicpm-2b.train-4x1024",
                                  "glm4-9b.serve-decode-b32",
                                  "minicpm-2b.serve-prefill-b4"])
def test_sound_run_is_correct(cell, tiny_run, one_thread):
    res = _run(tiny_run, cell)
    assert res["correct"], res["checks"]


# -- the executed plan: its ops return the output --------------------------

def _broken_matmul(monkeypatch, how):
    from repro_torch.kernels.matmul_int8 import ops
    real = ops.quantized_matmul

    def broken(x, w, **kw):
        if how == "unwritten":
            return torch.zeros(x.shape[0], w.shape[1])
        if how == "half_batch":
            out = real(x[: x.shape[0] // 2], w, **kw)
            return torch.cat([out, out])
        out = real(x, w, **kw)
        out[0, 0] += 0.5 * out.abs().max()
        return out
    monkeypatch.setattr(ops, "quantized_matmul", broken)


def _broken_flash(monkeypatch, how):
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention

    def broken(q, k, v, **kw):
        if how == "unwritten":
            return torch.zeros_like(q)
        if how == "half_batch":
            h = q.shape[0] // 2
            out = real(q[:h], k[:h], v[:h], **kw)
            return torch.cat([out, out])
        out = real(q, k, v, **kw)
        out[0, 0, 0, 0] += 0.5 * out.abs().max()
        return out
    monkeypatch.setattr(ops, "flash_attention", broken)


@pytest.mark.parametrize("how", ["unwritten", "half_batch", "altered"])
@pytest.mark.parametrize("kernel", ["matmul", "flash"])
def test_exec_faults(kernel, how, tiny_run, monkeypatch, one_thread):
    (_broken_matmul if kernel == "matmul" else _broken_flash)(monkeypatch,
                                                              how)
    res = _run(tiny_run, "glm4-9b.exec-decode32k")
    assert not res["correct"], res["checks"]


# -- training ---------------------------------------------------------------

@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_train_faults(how, tiny_run, monkeypatch, one_thread):
    from repro_torch.train import steps
    if how == "unchanged":
        monkeypatch.setattr(steps, "adamw_update",
                            lambda cfg, params, grads, state:
                            (params, state, {"lr": torch.zeros(()),
                                             "grad_norm": torch.zeros(())}))
    else:
        real = steps.lm_loss

        def half(params, cfg, tokens, labels, **kw):
            h = tokens.shape[0] // 2
            return real(params, cfg, tokens[:h], labels[:h], **kw)
        monkeypatch.setattr(steps, "lm_loss", half)
    res = _run(tiny_run, "minicpm-2b.train-4x1024")
    assert not res["correct"], res["checks"]


# -- serving: the step functions the drivers build -------------------------

def _broken_step(monkeypatch, maker, how):
    from repro_torch.train import steps
    real = getattr(steps, maker)

    def make(cfg, step_cfg, shard=None):
        fn = real(cfg, step_cfg, shard)

        def broken(params, batch, *caches):
            if how == "half_batch":
                h = batch["tokens"].shape[0] // 2
                if caches:
                    caches = (type(caches[0])(*(
                        None if t is None else torch.cat([t[:, :h]] * 2, 1)
                        if t.dim() > 1 else t for t in caches[0])),)
                batch = {"tokens": torch.cat([batch["tokens"][:h]] * 2)}
            logits, new = fn(params, batch, *caches)
            if how == "unchanged" and caches:
                new = caches[0]
            if how == "altered":       # every sequence's token
                logits = logits.clone()
                nxt = (logits.argmax(-1, keepdim=True) + 1) % logits.shape[-1]
                logits.scatter_(-1, nxt, logits.amax(-1, keepdim=True) + 1.0)
            return logits, new
        return broken
    monkeypatch.setattr(steps, maker, make)


@pytest.mark.parametrize("how", ["unchanged", "half_batch", "altered"])
def test_decode_faults(how, tiny_run, monkeypatch, one_thread):
    _broken_step(monkeypatch, "make_decode_step", how)
    res = _run(tiny_run, "glm4-9b.serve-decode-b32")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("how", ["half_batch", "altered"])
def test_prefill_faults(how, tiny_run, monkeypatch, one_thread):
    _broken_step(monkeypatch, "make_prefill_step", how)
    res = _run(tiny_run, "minicpm-2b.serve-prefill-b4")
    assert not res["correct"], res["checks"]
