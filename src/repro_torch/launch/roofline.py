"""Roofline analysis from dry-run records (`launch/dryrun.py`), with the
H100's rates (`launch/mesh.py`).

Three terms per (arch x shape x mesh), all in seconds per step:

    compute    = flops_per_device / PEAK_BF16_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

plus MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) and the useful-compute
ratio MODEL_FLOPS / counted flops (catches remat, padding and replication
waste).

The port's dry run counts the collectives one step issues with the plan
inside the forward (DTensor's functional collectives on the fake mesh,
`dryrun.CollectiveBytes`); the collective term reads them over one card's
NVLink rate, with `launch.mesh`'s caveat that a 16-wide ``model`` axis
spans two 8-card hosts, whose network is slower. A record whose
``collective_bytes_per_device`` is null (the step could not run on the
fake mesh) has no collective term, and `roofline_terms` says so
(``t_collective_s`` null, the record's reason beside it) rather than
reading it as 0 bytes. Its ``bytes_per_device`` are the step's arguments
read once (a lower bound on the memory term). The temporaries are counted
on each rank's local shards in the collective pass
(``memory.temp_bytes_per_device``; ``memory.temp_bytes`` summed over the
mesh, the reference's convention, which ``hbm_gb_per_device`` divides by
the device count), beside the unfused ``bytes_accessed_per_device``,
which no term reads.

    PYTHONPATH=src python -m repro_torch.launch.roofline --reports DIR
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_BF16_FLOPS


def model_flops(arch_id: str, shape_name: str) -> float:
    """Useful model FLOPs per step: 6·N_active·D (train) / 2·N_active·D
    (inference) for parameter matmuls, plus the sequence-mixer terms the
    6ND convention omits — causal-half attention score/value matmuls
    (2·B·L²·H·hd fwd) and SSD intra-chunk matmuls. 'Useful' credits only
    the causal half; full-L² compute shows up as waste in
    useful_compute_ratio (motivating the flash kernel path)."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    b = shape.global_batch
    l = shape.seq_len
    tokens = b * (1 if shape.is_decode else l)
    train = shape.kind == "train"
    fb = 3.0 if train else 1.0           # fwd(+2x bwd)
    total = (6.0 if train else 2.0) * n_active * tokens
    hd = cfg.resolved_head_dim
    # attention mixer
    n_attn = 0
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "encdec":
        n_attn = cfg.n_layers + cfg.encoder_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
    if n_attn and cfg.n_heads:
        if shape.is_decode:
            total += fb * 4.0 * b * l * cfg.n_heads * hd * n_attn
        else:
            total += fb * 2.0 * b * l * l * cfg.n_heads * hd * n_attn
    # SSD mixer (intra-chunk scores + value matmuls, chunk=256)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
        d_inner = cfg.ssm_expand * cfg.d_model
        n_h = d_inner // cfg.ssm_head_dim
        chunk = 256
        per_tok = 2.0 * chunk * n_h * (cfg.ssm_state + cfg.ssm_head_dim)
        if not shape.is_decode:
            total += fb * b * l * per_tok * cfg.n_layers
        else:
            total += fb * 2.0 * b * n_h * cfg.ssm_head_dim * \
                cfg.ssm_state * cfg.n_layers
    return total


def roofline_terms(rec: dict) -> dict:
    """rec: one dry-run JSON record (per-device quantities). A null
    quantity is an absent term: left out of ``dominant`` and the bound,
    reported null with its reason."""
    if rec.get("status") != "ok":
        return {"status": rec.get("status", "missing"),
                "reason": rec.get("reason", rec.get("error", ""))}
    n_dev = 1
    for v in rec["mesh"].values():
        n_dev *= v
    absent = {}
    flops = rec.get("flops_per_device")
    if flops is None:
        absent["compute"] = rec.get("flops_error") or "no flop count"
    t_compute = None if flops is None else float(flops) / PEAK_BF16_FLOPS
    t_memory = float(rec["bytes_per_device"]) / HBM_BW
    coll = rec.get("collective_bytes_per_device")
    if coll is None:
        absent["collective"] = rec.get("collective_reason") or \
            "no collective bytes in the record"
        t_coll = None
    else:
        coll = {k: max(v, 0.0) for k, v in coll.items()}
        t_coll = float(sum(coll.values())) / LINK_BW
    terms = {k: v for k, v in (("compute", t_compute), ("memory", t_memory),
                               ("collective", t_coll)) if v is not None}
    dominant = max(terms.items(), key=lambda kv: kv[1])[0]
    bound = max(terms.values())
    mflops = model_flops(rec["arch"], rec["shape"]) / n_dev
    mem = rec.get("memory", {})
    temp = mem.get("temp_bytes")
    return {
        "status": "ok",
        "n_devices": n_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "absent_terms": absent,
        "dominant": dominant,
        "model_flops_per_device": mflops,
        "useful_compute_ratio": mflops / flops if flops else None,
        "roofline_fraction": (mflops / PEAK_BF16_FLOPS) / bound
        if bound > 0 else 0.0,
        # argument bytes are per device, temporaries summed over the mesh;
        # a record without a memory count adds none
        "hbm_gb_per_device": (max(mem.get("argument_bytes", 0), 0) +
                              (max(temp, 0) / n_dev if temp is not None
                               else 0.0)) / 1e9,
        "temp_bytes_counted": temp is not None,
        "collective_breakdown": coll,
    }


def load_reports(report_dir: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(report_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def _ms(t) -> str:
    return "absent" if t is None else f"{t * 1e3:.2f}"


def format_table(report_dir: str, multi_pod: bool = False) -> str:
    rows = []
    hdr = (f"| arch | shape | t_comp(ms) | t_mem(ms) | t_coll(ms) | "
           f"dominant | useful | roofline-frac | HBM GB/dev |")
    sep = "|" + "---|" * 9
    rows += [hdr, sep]
    for rec in load_reports(report_dir):
        if rec.get("multi_pod") != multi_pod:
            continue
        t = roofline_terms(rec)
        if t["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | - | - | - | "
                        f"{t['status']}: {t.get('reason', '')[:40]} | - | - "
                        f"| - |")
            continue
        useful = t["useful_compute_ratio"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | "
            f"{_ms(t['t_compute_s'])} | {_ms(t['t_memory_s'])} | "
            f"{_ms(t['t_collective_s'])} | {t['dominant']} | "
            f"{'-' if useful is None else f'{useful:.2f}'} | "
            f"{t['roofline_fraction']:.3f} | "
            f"{t['hbm_gb_per_device']:.2f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Roofline table of the dry-run records in a directory "
                    "(H100 rates).")
    ap.add_argument("--reports", required=True,
                    help="directory of dry-run JSON records")
    ap.add_argument("--multi", action="store_true",
                    help="the multi-pod records instead of single-pod")
    a = ap.parse_args(argv)
    print(format_table(a.reports, a.multi))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
