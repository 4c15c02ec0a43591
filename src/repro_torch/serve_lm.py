"""Executed serving step on the card: the optimized CIM dataflow plan of
one served model under one registry scenario (``--shape``), run on the
port's CUDA kernels.

The counterpart of the reference's executed decode in
``examples/serve_lm.py`` (``report_cim_dataflow``) and of
``benchmarks/exec_lm.py`` (whose zoo is `repro_torch/exec_lm.py`). It
lowers the served step (a decode step, or the prompt pass of a prefill
scenario) to its workload, solves it with the MIREDO optimizer (cached
under ``MIREDO_CACHE``), lowers the result to an execution plan, and runs
every op on its kernel: each weight GEMM on matmul_int8 with blocks
derived from its optimized mapping, attention on flash_attention, the
fused SSD intra-chunk pair on ssd_scan. Every output is checked against
its oracle, and measured times are ranked against predicted cycles.

    PYTHONPATH=src python -m repro_torch.serve_lm --arch glm4-9b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.serve_lm --arch mamba2-1.3b --shape prefill_32k

The second is the prompt pass of 32 sequences of 32k tokens through
mamba2-1.3b at its published widths. Without a CUDA device the default
``--device cuda`` fails before solving; ``--device cpu --reduced`` runs
the plain versions at reduced widths. The solve runs before the first
CUDA call, and torch is imported only after the arguments are parsed.

``--live`` serves the model itself instead, the counterpart of the
reference's ``decode_demo`` (``examples/serve_lm.py``): random weights
drawn on the device from ``--seed``, float32 throughout, ``--batch``
prompts of ``--prompt-len`` tokens prefilled (a causal prefill of 512
positions or more runs its attention on flash_attention), the
self-attention KV caches padded to the prefill's positions plus the
generated ones, then ``--gen-len`` greedy decode steps, with the demo's
checks on the final caches. Every family is served; the ``vlm`` and
``encdec`` models take stub frontend embeddings of (batch,
``frontend_seq``, d_model), a standard normal drawn on the device after
the weights (the vlm's sit in front of the prompt, so its caches hold
``frontend_seq`` more positions):

    PYTHONPATH=src python -m repro_torch.serve_lm --live --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.serve_lm --live --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.serve_lm --live --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.serve_lm --live --reduced --device cpu

``--traffic`` serves a seeded Poisson request stream through the
request-level simulator (`core/serving.py`) instead, the reference's
``traffic_demo``: continuous batching against the serial baseline on
reduced glm4-9b, iteration costs from greedy solves of the stack. It runs
no device code, so ``--device`` does not apply:

    PYTHONPATH=src python -m repro_torch.serve_lm --traffic --n-requests 16
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any


def main(argv=None):
    """Solve, lower and execute, and return the ``ExecReport``; with
    ``--live``, serve the model and return the ``LiveReport``; with
    ``--traffic``, the (continuous batching, serial) ``ServeReport``s."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.core.cache import MIP_MODES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="decode_32k", choices=sorted(SHAPES))
    ap.add_argument("--mode", default="miredo",
                    choices=MIP_MODES + ("greedy", "heuristic", "random"))
    ap.add_argument("--per-layer-cap-s", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (ModelConfig.reduced), "
                         "small enough for a CPU run")
    ap.add_argument("--live", action="store_true",
                    help="serve the model itself: prefill, then greedy "
                         "decode (the options below)")
    ap.add_argument("--batch", type=int, default=4,
                    help="--live: prompts served together")
    ap.add_argument("--prompt-len", type=int, default=512,
                    help="--live: tokens per prompt")
    ap.add_argument("--gen-len", type=int, default=16,
                    help="--live: greedy tokens decoded per prompt")
    ap.add_argument("--traffic", action="store_true",
                    help="serve a Poisson request stream through the "
                         "continuous-batching simulator (no device code)")
    ap.add_argument("--n-requests", type=int, default=16,
                    help="--traffic: stream length")
    args = ap.parse_args(argv)
    if args.traffic:
        return traffic_demo(n_requests=args.n_requests, seed=args.seed)
    if args.live:
        return live(args)

    import torch

    from repro_torch.core.arch import default_arch
    from repro_torch.core.executor import check_device, execute_plan, \
        lower_plan
    from repro_torch.core.frontend import extract_workload
    from repro_torch.core.network import optimize_network

    check_device(args.device)          # fail before the solve, not after

    cfg, spec, arch = get_config(args.arch), SHAPES[args.shape], \
        default_arch()
    if args.reduced:
        cfg = cfg.reduced()
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), arch, args.mode,
                           counts=list(work.counts),
                           per_layer_cap_s=args.per_layer_cap_s, workers=1)
    print(f"[solve] {cfg.name} {spec.name} ({args.mode}): {len(work)} "
          f"layers, {net.n_unique} unique, {net.n_solved} solved, "
          f"{net.cache_hits} cache hits in {net.wall_s:.1f} s; "
          f"{net.totals['cycles']:.6g} cycles serial-sum, "
          f"EDP {net.totals['edp']:.6g}", flush=True)

    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 oracles
    plan = lower_plan(cfg, spec, net, arch)
    rep = execute_plan(plan, device=args.device, repeats=3, seed=args.seed,
                       verbose=True)
    rank = f"{rep.rank_corr:.4f}" if rep.rank_corr is not None else "n/a"
    print(f"[report] {rep.n_ops} ops ({rep.n_unique} unique) on "
          f"{args.device}: {rep.measured_total_s * 1e3:.4f} ms "
          f"count-weighted vs {plan.predicted_serial_cycles:.6g} predicted "
          f"cycles; rank corr {rank} over {len(rep.rank_points())} points; "
          f"numerics {'OK' if rep.numerics_ok else 'FAILED'} "
          f"(max rel err {rep.max_rel_err:.3e})", flush=True)
    return rep


@dataclasses.dataclass
class LiveReport:
    """One ``--live`` run. ``step_logits`` holds the last position's
    float32 logits of the prefill and of every decode step (gen_len + 1,
    B, V); ``frontend`` the stub frontend embeddings (vlm, encdec) or
    None; ``prefix`` the frontend positions in front of the prompt in the
    self-attention caches (the vlm's ``frontend_seq``, else 0);
    ``launches`` the kernel launches of the prefill and of each decode
    step; times are wall ms, each step synchronised on the card;
    ``peak_bytes`` is None on the CPU."""
    arch: str
    device: str
    batch: int
    prompt_len: int
    gen_len: int
    prefix: int
    model: Any
    prompt: Any
    frontend: Any
    tokens: Any
    step_logits: Any
    caches: Any
    init_s: float
    prefill_ms: float
    decode_ms: list
    peak_bytes: int | None
    launches: dict

    @property
    def max_seq(self) -> int:
        return self.prefix + self.prompt_len + self.gen_len

    @property
    def tokens_per_s(self) -> float:
        return self.batch * self.gen_len / (sum(self.decode_ms) / 1e3)


def _launch_counts() -> dict[str, int]:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    return {"flash_attention": fa_kernel.launches,
            "ssd_scan": ssd_kernel.launches}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in _launch_counts().items()}


def _self_kv(caches, family: str):
    """The self-attention KV caches of a ``family``'s caches, or None
    (ssm): the KVCache itself (dense, moe, vlm), the hybrid's (states,
    kv) or the encoder-decoder's (kv, cross K/V, memory)."""
    if family in ("dense", "moe", "vlm"):
        return caches
    if family == "ssm":
        return None
    if family == "hybrid":
        return caches[1]
    if family == "encdec":
        return caches[0]
    raise ValueError(f"no cache layout for family {family!r}")


def pad_caches(caches, max_seq: int, family: str):
    """A ``family``'s self-attention KV caches grown along their sequence
    axis to ``max_seq`` positions of zeros, so that decode can append (the
    demo's pad). Only those grow: SSM states, the encoder-decoder's cross
    K/V and memory pass through."""
    import torch.nn.functional as F
    kv = _self_kv(caches, family)
    if kv is None:
        return caches
    grow = max_seq - kv.k.shape[2]
    pad = lambda t: None if t is None else F.pad(t, (0, 0, 0, 0, 0, grow))
    grown = kv._replace(k=pad(kv.k), v=pad(kv.v), k_scale=pad(kv.k_scale),
                        v_scale=pad(kv.v_scale))
    if family == "hybrid":
        return caches[0], grown
    if family == "encdec":
        return (grown,) + tuple(caches[1:])
    return grown


def _check_live(cfg, caches, tokens, batch: int, gen_len: int,
                max_seq: int) -> str:
    """The demo's checks on the greedy tokens and on each family's final
    caches; returns what held. ``max_seq``: the self-attention positions
    (prefix + prompt + generated)."""
    import torch

    from repro_torch.models.ssm import init_ssm_state
    from repro_torch.models.transformer import hybrid_groups
    if tuple(tokens.shape) != (batch, gen_len + 1) or \
            bool((tokens < 0).any()):
        raise RuntimeError(f"greedy tokens {tuple(tokens.shape)}")
    held = []
    kv = _self_kv(caches, cfg.family)
    if kv is not None:
        # the final cache length is exactly every position prefilled or
        # generated, and the last position was written (a dropped
        # one-hot write would leave it 0)
        if not bool((kv.length == max_seq).all()):
            raise RuntimeError(f"cache lengths {kv.length.tolist()} != "
                               f"{max_seq}")
        if not bool((kv.k[:, :, max_seq - 1] != 0).any()):
            raise RuntimeError("the last decode write was dropped")
        held.append(f"{kv.k.shape[0]} KV caches of length {max_seq}, last "
                    f"position written")
    if cfg.family in ("ssm", "hybrid"):
        states = caches if cfg.family == "ssm" else caches[0]
        proto = init_ssm_state(batch, cfg, cfg.d_model)
        for name, got, want in zip(("h", "conv"), states, proto):
            if tuple(got.shape) != (cfg.n_layers,) + tuple(want.shape) or \
                    not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"SSM state {name} {tuple(got.shape)}")
        held.append(f"SSM states h {tuple(states.h.shape)}, conv "
                    f"{tuple(states.conv.shape)} finite")
    if cfg.family == "hybrid" and kv.k.shape[0] != hybrid_groups(cfg)[0]:
        raise RuntimeError(f"{kv.k.shape[0]} KV caches, not one a group")
    if cfg.family == "encdec":
        (ck, cv), memory = caches[1], caches[2]
        want = (cfg.n_layers, batch, cfg.frontend_seq, cfg.n_kv_heads,
                cfg.resolved_head_dim)
        if tuple(ck.shape) != want or tuple(cv.shape) != want or \
                tuple(memory.shape) != (batch, cfg.frontend_seq,
                                        cfg.d_model) or \
                not all(bool(torch.isfinite(t).all()) for t in (ck, cv,
                                                                memory)):
            raise RuntimeError(f"cross K/V {tuple(ck.shape)}, memory "
                               f"{tuple(memory.shape)}")
        held.append(f"cross K/V {tuple(ck.shape)} and memory "
                    f"{tuple(memory.shape)} finite")
    return "; ".join(held)


def live(args) -> LiveReport:
    """Serve ``args.arch``: init on the device, prefill, greedy decode."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.executor import check_device
    from repro_torch.models.transformer import init_model
    from repro_torch.train.steps import StepConfig, make_decode_step, \
        make_prefill_step

    check_device(args.device)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    batch, prompt_len, gen_len = args.batch, args.prompt_len, args.gen_len
    if min(batch, prompt_len, gen_len) < 1:
        raise ValueError("--batch, --prompt-len and --gen-len must be >= 1")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False   # float32 compute
        torch.cuda.reset_peak_memory_stats(device)
    where = torch.cuda.get_device_name(device) if on_card else "cpu"

    t0 = time.monotonic()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_model(cfg, gen, torch.float32, device)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[live] {cfg.name} ({cfg.family}) on {where}: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {n_params:,} parameters "
          f"({4 * n_params / 1e9:.3f} GB float32), drawn in {init_s:.2f} s",
          flush=True)

    step_cfg = StepConfig(use_flash=True, compute_dtype=torch.float32)
    prefill = make_prefill_step(cfg, step_cfg)
    decode = make_decode_step(cfg, step_cfg)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)
    batch_in = {"tokens": prompt}
    frontend = None
    if cfg.family in ("vlm", "encdec"):
        frontend = torch.randn((batch, cfg.frontend_seq, cfg.d_model),
                               generator=gen, device=device)
        batch_in["frontend"] = frontend
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    max_seq = prefix + prompt_len + gen_len

    before = _launch_counts()
    sync()
    t0 = time.monotonic()
    logits, caches = prefill(model, batch_in)
    sync()
    prefill_ms = (time.monotonic() - t0) * 1e3
    launches = {"prefill": _since(before), "decode": []}
    caches = pad_caches(caches, max_seq, cfg.family)
    step_logits = [logits.to(torch.float32)]
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    decode_ms = []
    for _ in range(gen_len):
        before = _launch_counts()
        sync()
        t0 = time.monotonic()
        logits, caches = decode(model, {"tokens": toks[-1]}, caches)
        toks.append(torch.argmax(logits, dim=-1)[:, None])
        sync()
        decode_ms.append((time.monotonic() - t0) * 1e3)
        launches["decode"].append(_since(before))
        step_logits.append(logits.to(torch.float32))
    tokens = torch.cat(toks, dim=1)
    step_logits = torch.stack(step_logits)
    if not bool(torch.isfinite(step_logits).all()):
        raise RuntimeError("non-finite logits")
    held = _check_live(cfg, caches, tokens, batch, gen_len, max_seq)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    rep = LiveReport(arch=cfg.name, device=where, batch=batch,
                     prompt_len=prompt_len, gen_len=gen_len, prefix=prefix,
                     model=model, prompt=prompt, frontend=frontend,
                     tokens=tokens, step_logits=step_logits,
                     caches=caches, init_s=init_s, prefill_ms=prefill_ms,
                     decode_ms=decode_ms, peak_bytes=peak, launches=launches)
    per_step = set(tuple(d.values()) for d in launches["decode"])
    print(f"[live] prefill {batch} x "
          f"{f'({prefix} + {prompt_len})' if prefix else prompt_len}: "
          f"{prefill_ms:.3f} ms; "
          f"launches {launches['prefill']}", flush=True)
    print(f"[live] decode {gen_len} tokens x {batch} sequences: "
          f"{sum(decode_ms):.3f} ms (median "
          f"{statistics.median(decode_ms):.3f} ms a step), "
          f"{rep.tokens_per_s:.2f} tokens/s; launches per step (flash, "
          f"ssd) {sorted(per_step)}", flush=True)
    print(f"[live] peak device memory "
          f"{'not measured (CPU)' if peak is None else f'{peak:,} bytes'}; "
          f"{held}", flush=True)
    print(f"[live] sample token ids {tokens[0, :12].tolist()}", flush=True)
    return rep


def traffic_demo(n_requests: int = 16, seed: int = 0):
    """Serve a seeded Poisson request stream against reduced glm4-9b:
    iteration costs from greedy solves of the stack, continuous batching
    against the serial baseline. Returns both ``ServeReport``s."""
    from repro_torch.configs import get_config
    from repro_torch.core.arch import default_arch
    from repro_torch.core.serving import (NetworkCostModel, RequestStream,
                                          ServeConfig, serial_baseline,
                                          simulate_serving)

    cfg = get_config("glm4-9b").reduced()
    arch = default_arch()
    serve_cfg = ServeConfig(kv_capacity_tokens=512, max_batch_requests=16,
                            max_batch_tokens=128)
    cost = NetworkCostModel(cfg, arch, max_m=serve_cfg.max_batch_tokens,
                            context_len=256, mode="greedy")
    stream = RequestStream.poisson(n_requests, seed=seed,
                                   mean_interarrival_cycles=150_000.0)
    rep = simulate_serving(stream, cost, serve_cfg)
    ser = serial_baseline(stream, cost, serve_cfg)
    f = cost.freq_ghz
    s, ss = rep.summary(f), ser.summary(f)
    to_ms = 1.0 / (f * 1e6)
    print(f"served {n_requests} requests on {arch.name} "
          f"({cost.n_solves} anchor solves):")
    print(f"  TTFT p50/p99: {s['ttft_p50_cycles'] * to_ms:.3f} / "
          f"{s['ttft_p99_cycles'] * to_ms:.3f} ms   "
          f"ITL p50/p99: {s['itl_p50_cycles'] * to_ms:.3f} / "
          f"{s['itl_p99_cycles'] * to_ms:.3f} ms")
    print(f"  continuous batching: {s['tokens_per_sec']:.4g} tok/s "
          f"({int(s['n_merged_iterations'])} merged iterations) vs "
          f"serial {ss['tokens_per_sec']:.4g} tok/s")
    if rep.makespan_cycles > ser.makespan_cycles:
        raise RuntimeError(f"continuous batching took "
                           f"{rep.makespan_cycles} cycles, serial "
                           f"{ser.makespan_cycles}")
    return rep, ser


if __name__ == "__main__":
    report = main()
    raise SystemExit(0 if isinstance(report, (LiveReport, tuple)) or
                     report.numerics_ok else 1)
