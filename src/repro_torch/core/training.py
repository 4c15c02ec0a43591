"""Training-workload lowering: backward-pass GEMMs + the optimizer-step
traffic term (DESIGN.md §Training frontend, ROADMAP item 4).

The forward frontend (`core/frontend.py`) lowers every registry model to
weight-GEMMs ``Y = X . W`` — (M x K_red) @ (K_red x N_out), canonical
N=M, K=N_out, C=K_red (`workload.gemm`). A training step runs each of
them three times, and the two backward forms transpose the operands:

    forward   Y  = X . W            gemm(M,    N_out, K_red)
    dGrad     dX = dY . W^T         gemm(M,    K_red, N_out)  OP_DGRAD
    wGrad     dW = X^T . dY         gemm(K_red, N_out, M)     OP_WGRAD

All three have identical MACs (M * N_out * K_red), so a dense model's
backward exactly doubles its forward GEMM MACs — the embedding gather
contributes zero MACs on both sides, the same convention the forward
frontend uses. What changes is *which operand is stationary*:

  * dGrad's macro-resident operand is W^T — still a preloadable weight,
    so residency packing (`core/scheduler.py`) applies unchanged.
  * wGrad's macro-resident ("weight"-slot) operand is dY, an activation
    gradient *produced by this very step*. `Layer.weight_written` marks
    it: `scheduler.weight_residency` returns (False, 0.0) for written
    layers (nothing exists to preload, so the one-time program-in cannot
    amortize across pipelined items), `cache.layer_cache_key` keeps such
    layers from aliasing same-shaped forward layers, and the mesh rules
    route them through the FSDP gradient shards
    (`sharding.rules.mesh_grad_choices`).
  * activation-activation matmuls (the SSD duality forms, `OP_SSD`) have
    no weight at all: both backward GEMMs are activation grads — emitted
    tagged `OP_DGRAD` with ``weight_written=True`` on both sides (the
    stationary operand is always a forward activation or a gradient) and
    excluded from the optimizer update.

MoE routing: dGrad mirrors the forward multiplicities exactly (every
routed token-assignment backpropagates), but wGrad exists only for the
experts actually *hit* — with ``m * top_k`` token-assignments over ``E``
experts, at most ``min(E, m * top_k)`` experts received tokens, so the
routed ``.exp.*`` wGrad count scales by ``n_hit / E``.

The optimizer step itself is not a GEMM: per distinct weight set it reads
the fp32 gradient, reads+writes both Adam moments (`train/optimizer.py`:
fp32 m and v) and writes the requantized INT8 weight image back for the
macros. That traffic is priced once per step, never per tile, through the
same eq. 9/11-style machinery the per-layer model uses: bytes over the
DRAM bus width (`arch.level(0).bytes_per_cycle()`, the eq. 11 chunk
form) and per-byte (source + destination) access energy for the
DRAM<->GBuf hop, mirroring `energy.operand_energy_hops`' coefficient
convention. On a multi-chip mesh, data-parallel gradient sync adds one
ring all-reduce of the fp32 gradients (reduce-scatter + all-gather,
`latency.ring_allreduce_cycles` — the FSDP collective).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import workload as wl
from repro_torch.core.arch import WEIGHT

#: Optimizer-state byte widths (`train/optimizer.py`: OPT_STATE_DTYPE is
#: fp32 for gradients and both Adam moments); the updated weight image is
#: written back requantized to the macros' INT8.
GRAD_BYTES = 4
MOMENT_BYTES = 4
ADAM_MOMENTS = 2
WEIGHT_IMAGE_BYTES = 1

#: Forward op kinds whose stationary operand is a true (trainable) weight.
_WEIGHTFUL_OPS = (wl.OP_GEMM, wl.OP_ATTENTION)
#: Name marker of top-k-routed MoE expert GEMMs (`lm_workloads.moe_gemms`
#: emits ``{prefix}.exp.ffn_up`` / ``.exp.ffn_down``; shared experts and
#: arctic's dense residual use other markers and train like dense FFNs).
_ROUTED_MARKER = ".exp."


def update_bytes_per_param() -> int:
    """DRAM bytes one parameter costs per optimizer step: gradient read +
    both Adam moments read and written + weight image write."""
    return GRAD_BYTES + 2 * ADAM_MOMENTS * MOMENT_BYTES + WEIGHT_IMAGE_BYTES


def routed_hit_experts(cfg: ModelConfig, m_tokens: int) -> int:
    """Experts that can receive >= 1 token under top-k routing of
    ``m_tokens`` tokens: ``min(E, m * top_k)``. 0 for non-MoE configs."""
    if not (cfg.n_experts and cfg.top_k):
        return 0
    return min(cfg.n_experts, m_tokens * cfg.top_k)


def backward_gemms(forward: Sequence[tuple[wl.Layer, int]],
                   cfg: ModelConfig, spec: ShapeSpec
                   ) -> list[tuple[wl.Layer, int]]:
    """Expand a forward (layer, count) stream into its backward stream.

    Emitted in *reversed* forward order (backprop executes the network
    back to front), one dGrad + one wGrad per forward GEMM, per the
    module-docstring transposition table. The ``.wgrad`` of an
    activation-activation matmul (`OP_SSD` forward) is itself an
    activation grad: tagged `OP_DGRAD` (no optimizer state behind it) but
    still ``weight_written`` — its stationary operand is produced too.
    """
    assert spec.kind == "train", spec.kind
    out: list[tuple[wl.Layer, int]] = []
    n_exp, n_hit = cfg.n_experts, routed_hit_experts(cfg, spec.m_tokens)
    for layer, count in reversed(list(forward)):
        assert layer.is_gemm and layer.op in wl.OP_KINDS[:3], \
            (layer.name, layer.op)
        m, n_out, k_red = (layer.bound("N"), layer.bound("K"),
                           layer.bound("C"))
        weightful = layer.op in _WEIGHTFUL_OPS
        out.append((wl.gemm(f"{layer.name}.dgrad", m, k_red, n_out,
                            op=wl.OP_DGRAD,
                            weight_written=not weightful), count))
        w_count = count
        if n_hit and _ROUTED_MARKER in layer.name:
            assert count % n_exp == 0, (layer.name, count, n_exp)
            w_count = (count // n_exp) * n_hit
        out.append((wl.gemm(f"{layer.name}.wgrad", k_red, n_out, m,
                            op=wl.OP_WGRAD if weightful else wl.OP_DGRAD,
                            weight_written=True), w_count))
    return out


# ---------------------------------------------------------------------------
# Optimizer-step traffic (once per step, never per tile)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UpdateCost:
    """The optimizer step's once-per-step DRAM + collective bill."""

    n_params: int            # distinct trainable params (weight sets)
    dram_bytes: int          # DRAM bytes touched per step
    cycles: float            # DRAM-bus cycles (eq. 11 chunk form)
    energy_pj: float         # DRAM<->GBuf access energy
    comm_cycles: float = 0.0     # mesh gradient ring all-reduce
    comm_energy_pj: float = 0.0  # link energy of that collective

    @property
    def total_cycles(self) -> float:
        return self.cycles + self.comm_cycles

    @property
    def total_energy_pj(self) -> float:
        return self.energy_pj + self.comm_energy_pj


def trainable_params(layers_counts: Sequence[tuple[wl.Layer, int]], *,
                     inst: int = 1) -> int:
    """Distinct trainable parameters of a lowered (layer, count) stream.

    Counts are depth x batch multiplicities; batch instances share
    weights, so each layer contributes ``count // inst`` distinct weight
    sets (`inst` = `ShapeSpec.instance_count` — the same depth-repeats
    convention the scheduler documents; conservative for parameter-shared
    blocks like zamba2's, which re-count the shared weights per apply).
    Backward layers, written-operand layers and activation-activation ops
    carry no trainable weight and contribute nothing.
    """
    n = 0
    for layer, count in layers_counts:
        if layer.op not in _WEIGHTFUL_OPS or layer.weight_written:
            continue
        assert count % inst == 0, (layer.name, count, inst)
        n += (count // inst) * layer.operand_elems(WEIGHT)
    return n


def optimizer_update_cost(layers_counts: Sequence[tuple[wl.Layer, int]],
                          arch, *, inst: int = 1) -> UpdateCost:
    """Price one optimizer step for a lowered workload on ``arch`` (a
    `CimArch`, or a `mesh.MeshArch` — then the FSDP gradient ring
    all-reduce is added and DRAM pricing uses the chip).

    Charged ONCE per training step: the update touches each parameter a
    fixed number of times regardless of how its GEMMs were tiled, so this
    term lives outside the per-layer records (which would re-bill it per
    tile or per instance)."""
    mesh = arch if getattr(arch, "n_chips", 1) > 1 else None
    chip = getattr(arch, "chip", arch)
    n_params = trainable_params(layers_counts, inst=inst)
    dram_bytes = n_params * update_bytes_per_param()
    # eq. 11 chunk form on the DRAM bus; (e_src + e_dst) per byte for the
    # DRAM<->GBuf hop, `energy.operand_energy_hops`' coefficient.
    cycles = float(math.ceil(dram_bytes / chip.level(0).bytes_per_cycle()))
    e_hop = (chip.level(0).access_energy_pj_per_byte +
             chip.level(1).access_energy_pj_per_byte)
    energy = dram_bytes * e_hop
    comm_cycles = comm_energy = 0.0
    if mesh is not None:
        from repro_torch.core.latency import ring_allreduce_cycles
        grad_bytes = n_params * GRAD_BYTES
        comm_cycles = ring_allreduce_cycles(grad_bytes, mesh.link,
                                            mesh.n_chips)
        # 2(N-1) single-hop ring steps of 1/N chunks (reduce-scatter +
        # all-gather), priced like `mesh.shard_eval`'s all-reduce term
        comm_energy = (mesh.link.energy_pj_per_byte *
                       2 * (mesh.n_chips - 1) * (grad_bytes / mesh.n_chips))
    return UpdateCost(n_params=n_params, dram_bytes=dram_bytes,
                      cycles=cycles, energy_pj=energy,
                      comm_cycles=comm_cycles, comm_energy_pj=comm_energy)


# ---------------------------------------------------------------------------
# Phase splits + the backward-dataflow headline
# ---------------------------------------------------------------------------

def phase_of(layer: wl.Layer) -> str:
    """fwd | dgrad | wgrad bucket of one lowered layer (activation-
    activation backward ops land in dgrad — they carry that tag)."""
    if layer.op == wl.OP_WGRAD:
        return "wgrad"
    if layer.op == wl.OP_DGRAD:
        return "dgrad"
    return "fwd"


def cycle_splits(net) -> dict[str, float]:
    """Serial-sum cycles of a solved training network by phase."""
    out = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    for lr in net.layers:
        out[phase_of(lr.layer)] += lr.count * lr.record["cycles"]
    return out


#: Canonical-dim -> GEMM-role maps. Raw loop dims of a backward layer
#: trivially differ from its forward's (the bounds are transposed), so
#: dataflow comparison happens in *role* space: M = tokens, N = the
#: forward weight's output channels, K = the forward reduction dim.
_FWD_ROLES = {"N": "M", "K": "N", "C": "K"}
_ROLES_BY_OP = {
    wl.OP_DGRAD: {"N": "M", "K": "K", "C": "N"},
    wl.OP_WGRAD: {"N": "K", "K": "N", "C": "M"},
}


def dataflow_signature(mapping_json: dict, op: str) -> tuple:
    """Structural dataflow signature of a solved mapping in GEMM-role
    space: which roles each spatial axis parallelizes and the temporal
    role order, factors dropped (trivial factor-1 entries excluded).
    Two layers share a signature iff the MIP chose the same *dataflow* —
    same stationarity/parallelization structure — for them, regardless of
    their (transposed) bounds."""
    roles = _ROLES_BY_OP.get(op, _FWD_ROLES)
    spatial = tuple(
        (ax, tuple(roles.get(d, d) for d, f in entries if f > 1))
        for ax, entries in sorted(mapping_json["spatial"].items()))
    temporal = tuple(roles.get(d, d) for d, f in mapping_json["temporal"]
                     if f > 1)
    return spatial, temporal


def backward_dataflow_diffs(net) -> list[dict]:
    """Per wGrad layer: does the MIP-optimal backward dataflow differ
    from the forward layer's? — the training benchmark's headline. Pairs
    each unique ``<name>.wgrad`` record with its forward ``<name>``
    record and compares role-space signatures."""
    fwd = {}
    for lr in net.layers:
        if phase_of(lr.layer) == "fwd":
            fwd.setdefault(lr.layer.name, lr)
    out, seen = [], set()
    for lr in net.layers:
        name = lr.layer.name
        if lr.layer.op != wl.OP_WGRAD or not name.endswith(".wgrad") \
                or name in seen:
            continue
        seen.add(name)
        flr = fwd.get(name[:-len(".wgrad")])
        if flr is None:
            continue
        fsig = dataflow_signature(flr.record["mapping"], flr.layer.op)
        wsig = dataflow_signature(lr.record["mapping"], wl.OP_WGRAD)
        out.append({"layer": flr.layer.name, "differs": fsig != wsig,
                    "fwd_signature": fsig, "wgrad_signature": wsig})
    return out


# ---------------------------------------------------------------------------
# End-to-end: one training step through the network pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainingResult:
    """One solved training step: the network result over
    fwd + dGrad + wGrad plus the once-per-step optimizer bill."""

    net: object              # network.NetworkResult
    update: UpdateCost
    splits: dict             # serial cycles by phase (cycle_splits)

    @property
    def step_cycles(self) -> float:
        """End-to-end cycles of one step: the scheduled network makespan
        (serial sum when scheduling was skipped) + the update."""
        s = self.net.scheduled
        base = s["cycles"] if s else self.net.totals["cycles"]
        return base + self.update.total_cycles

    @property
    def step_energy_pj(self) -> float:
        return self.net.totals["energy_pj"] + self.update.total_energy_pj


def optimize_training(cfg: ModelConfig, spec: ShapeSpec, arch=None,
                      mode: str = "miredo", *, mesh=None,
                      **net_kwargs) -> TrainingResult:
    """Lower ``cfg`` under a ``kind="train"`` spec (forward + backward via
    `frontend.extract_workload`), solve it through the network pipeline,
    and attach the optimizer-step bill. ``mesh=`` routes through the mesh
    pipeline and adds the gradient collective to the update."""
    from repro_torch.core.frontend import extract_workload
    from repro_torch.core.network import optimize_network

    assert spec.kind == "train", spec.kind
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), arch, mode, mesh=mesh,
                           counts=list(work.counts), **net_kwargs)
    update = optimizer_update_cost(
        list(zip(work.layers, work.counts)),
        mesh if mesh is not None else arch,
        inst=spec.instance_count)
    return TrainingResult(net=net, update=update, splits=cycle_splits(net))
