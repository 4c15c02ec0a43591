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
tokens or more runs its attention on flash_attention), the KV caches
padded to prompt + generated positions, then ``--gen-len`` greedy decode
steps, with the demo's checks on the final caches:

    PYTHONPATH=src python -m repro_torch.serve_lm --live --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.serve_lm --live --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.serve_lm --live --reduced --device cpu

The ``dense`` and ``ssm`` families are served (glm4-9b, mamba2-1.3b, ...);
the others raise until their models are ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any


def main(argv=None):
    """Solve, lower and execute, and return the ``ExecReport``; with
    ``--live``, serve the model and return the ``LiveReport``."""
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
    args = ap.parse_args(argv)
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
    B, V); ``launches`` the kernel launches of the prefill and of each
    decode step; times are wall ms, each step synchronised on the card;
    ``peak_bytes`` is None on the CPU."""
    arch: str
    device: str
    batch: int
    prompt_len: int
    gen_len: int
    model: Any
    prompt: Any
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
        return self.prompt_len + self.gen_len

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


def pad_caches(caches, max_seq: int):
    """KV caches grown along their sequence axis to ``max_seq`` positions
    of zeros, so that decode can append (the demo's pad); SSM states have
    no sequence axis and pass through."""
    import torch.nn.functional as F

    from repro_torch.models.attention import KVCache
    if not isinstance(caches, KVCache):
        return caches
    grow = max_seq - caches.k.shape[2]
    pad = lambda t: None if t is None else F.pad(t, (0, 0, 0, 0, 0, grow))
    return caches._replace(k=pad(caches.k), v=pad(caches.v),
                           k_scale=pad(caches.k_scale),
                           v_scale=pad(caches.v_scale))


def _check_live(cfg, caches, tokens, batch: int, prompt_len: int,
                gen_len: int) -> str:
    """The demo's checks; returns what held."""
    import torch
    max_seq = prompt_len + gen_len
    if tuple(tokens.shape) != (batch, gen_len + 1) or \
            bool((tokens < 0).any()):
        raise RuntimeError(f"greedy tokens {tuple(tokens.shape)}")
    if cfg.family == "dense":
        # the final cache length is exactly every prompt + generated
        # token, and the last position was written (a dropped one-hot
        # write would leave it 0)
        if not bool((caches.length == max_seq).all()):
            raise RuntimeError(f"cache lengths {caches.length.tolist()} != "
                               f"{prompt_len} + {gen_len}")
        if not bool((caches.k[:, :, max_seq - 1] != 0).any()):
            raise RuntimeError("the last decode write was dropped")
        return (f"cache length {max_seq} = {prompt_len} + {gen_len}, last "
                f"position written")
    from repro_torch.models.ssm import init_ssm_state
    proto = init_ssm_state(batch, cfg, cfg.d_model)
    for name, got, want in zip(("h", "conv"), caches, proto):
        if tuple(got.shape) != (cfg.n_layers,) + tuple(want.shape) or \
                not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"SSM state {name} {tuple(got.shape)}")
    return (f"SSM states h {tuple(caches.h.shape)}, conv "
            f"{tuple(caches.conv.shape)}")


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
    model = init_model(cfg, torch.Generator(device=device).manual_seed(
        args.seed), torch.float32, device)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[live] {cfg.name} on {where}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {n_params:,} parameters "
          f"({4 * n_params / 1e9:.3f} GB float32), drawn in {init_s:.2f} s",
          flush=True)

    step_cfg = StepConfig(use_flash=True, compute_dtype=torch.float32)
    prefill = make_prefill_step(cfg, step_cfg)
    decode = make_decode_step(cfg, step_cfg)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)

    before = _launch_counts()
    sync()
    t0 = time.monotonic()
    logits, caches = prefill(model, {"tokens": prompt})
    sync()
    prefill_ms = (time.monotonic() - t0) * 1e3
    launches = {"prefill": _since(before), "decode": []}
    caches = pad_caches(caches, prompt_len + gen_len)
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
    held = _check_live(cfg, caches, tokens, batch, prompt_len, gen_len)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    rep = LiveReport(arch=cfg.name, device=where, batch=batch,
                     prompt_len=prompt_len, gen_len=gen_len, model=model,
                     prompt=prompt, tokens=tokens, step_logits=step_logits,
                     caches=caches, init_s=init_s, prefill_ms=prefill_ms,
                     decode_ms=decode_ms, peak_bytes=peak, launches=launches)
    per_step = set(tuple(d.values()) for d in launches["decode"])
    print(f"[live] prefill {batch} x {prompt_len}: {prefill_ms:.3f} ms; "
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


if __name__ == "__main__":
    report = main()
    raise SystemExit(0 if isinstance(report, LiveReport) or
                     report.numerics_ok else 1)
