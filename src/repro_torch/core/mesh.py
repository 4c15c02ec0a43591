"""Multi-chip mesh optimization: N identical CIM chips on a parameterized
interconnect, per-layer tensor-parallel sharding, and the mesh-level
network pipeline (DESIGN.md §Mesh optimization, ROADMAP item 2).

The single-chip stack stops at `scheduler.py`'s residency packing: a model
whose weights exceed one chip's macros can never keep them resident. This
module extends the hierarchy one level up — a `MeshArch` of ``n_chips``
identical `CimArch` chips connected by a `MeshLink` (bandwidth bits/cycle,
per-hop latency, per-byte energy) in a 1D ring or 2D grid — following the
same layering discipline the chip abstraction uses (CIMFlow,
arXiv:2505.01107: the chip level is a clean layer, not a fork):

  * **Shard choices** per layer (`shard_choices`, driven by the axis rules
    in `sharding/rules.py`): ``replicate`` (the whole layer on one chip —
    always valid, the rules' fully-FSDP fallback analog), ``split_n``
    (tensor-parallel over output channels, canonical dim K: input
    broadcast + output gather) and ``split_k`` (over the reduction dim C:
    input scatter + a ring all-reduce of 32-bit partial sums).
  * **Inter-chip transfer terms** (`shard_eval`): eq. 9-style — sharded
    operand bytes and all-reduce volume over the link bandwidth, charged
    per hop count of the topology (`latency.link_transfer_cycles`,
    `latency.ring_allreduce_cycles`; the NoC dataflow constant,
    arXiv:2111.11744).
  * **Mesh network pipeline** (`optimize_mesh_network`): per unique layer,
    solve every valid shard's sub-layer through the existing single-chip
    pipeline (`network.optimize_network` on ``mesh.chip`` — dedup,
    MAC-weighted budgets, process fan-out and the chip-keyed record cache
    all apply), then pick the cheapest (chip + communication) choice and
    emit a *mesh record* (chip cycles + comm cycles, energy over active
    chips + link energy, the shard decomposition). Mesh records cache
    under `cache.solve_record_key` with the **mesh fingerprint** as the
    arch component (CACHE_VERSION 6): two meshes differing only in link
    bandwidth never share records.
  * **Mesh schedule** (`scheduler.schedule_mesh`): the segment MIP
    generalized to one-hot (chip, core) placement with per-chip residency
    capacity and a shared makespan epigraph; greedy water-filling
    fallback preserved so the MIP never loses by construction.

Invariant: a 1-chip mesh is the single chip — `network.optimize_network`
with ``mesh=MeshArch(chip, 1)`` takes today's single-chip path bit for bit
(`tests/test_mesh.py`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

from repro_torch.core import workload as wl
from repro_torch.core.arch import (CimArch, INPUT, MeshLink, OUTPUT, WEIGHT,
                             arch_fingerprint, default_arch)
from repro_torch.core.latency import link_transfer_cycles, ring_allreduce_cycles

TOPOLOGIES = ("ring", "grid")

#: Shard choices, in deterministic preference order (ties in (cycles,
#: energy) resolve to the earlier choice — replicate, the no-comm option).
REPLICATE = "replicate"
SPLIT_N = "split_n"
SPLIT_K = "split_k"
SHARD_CHOICES = (REPLICATE, SPLIT_N, SPLIT_K)

#: Canonical loop dim each split divides. GEMM (M x K_red) @ (K_red x
#: N_out) enters the nest as N=M, K=N_out, C=K_red (`workload.gemm`), so
#: "split N_out" divides canonical K and "split K_red" divides canonical C.
SPLIT_DIM = {SPLIT_N: "K", SPLIT_K: "C"}

#: Operand byte widths at the mesh level: activations travel between chips
#: as 8-bit requantized values (`arch.operand_bits` outer-hierarchy
#: convention); split_k partial sums are exchanged pre-requantization at
#: 32 bits (the all-reduce operates on accumulator precision). Weight
#: gradients (the OUTPUT of a wGrad GEMM, `workload.OP_WGRAD`) leave the
#: chip unquantized too — they feed the fp32 optimizer state
#: (`train/optimizer.py`), not another MVM.
ACT_BYTES = 1
PSUM_BYTES = 4
GRAD_BYTES = 4


def out_bytes_per_elem(layer: wl.Layer) -> int:
    """Inter-chip byte width of one OUTPUT element of ``layer``: fp32 for
    weight-grad GEMMs, requantized INT8 activations otherwise."""
    return GRAD_BYTES if layer.op == wl.OP_WGRAD else ACT_BYTES


# ---------------------------------------------------------------------------
# MeshArch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshArch:
    """``n_chips`` identical chips on a ring or 2D-grid interconnect.

    ``chip`` is a full `CimArch`; the mesh adds only the chip count, the
    link and the topology — every intra-chip question still goes to the
    chip abstraction (the mesh is a layer, not a fork)."""

    chip: CimArch
    n_chips: int = 1
    link: MeshLink = MeshLink()
    topology: str = "ring"
    name: str = "mesh"

    def validate(self) -> None:
        self.chip.validate()
        self.link.validate()
        assert self.n_chips >= 1, self.n_chips
        assert self.topology in TOPOLOGIES, self.topology

    # ---- topology geometry ------------------------------------------------
    def grid_dims(self) -> tuple[int, int]:
        """Near-square (rows, cols) factorization for the 2D grid."""
        r = max(1, int(math.isqrt(self.n_chips)))
        while self.n_chips % r:
            r -= 1
        return r, self.n_chips // r

    def chip_distance(self, a: int, b: int) -> int:
        """Hop count between two chips under the topology."""
        if a == b or self.n_chips <= 1:
            return 0
        if self.topology == "ring":
            d = abs(a - b)
            return min(d, self.n_chips - d)
        _, cols = self.grid_dims()
        return abs(a // cols - b // cols) + abs(a % cols - b % cols)

    def bcast_hops(self) -> int:
        """Worst-case hop distance from any chip — the per-chunk hop count
        a broadcast/scatter/gather from one host chip is charged with."""
        if self.n_chips <= 1:
            return 0
        if self.topology == "ring":
            return self.n_chips // 2
        r, c = self.grid_dims()
        return (r - 1) + (c - 1)

    # ---- identity ---------------------------------------------------------
    def fingerprint(self) -> str:
        """Structural serialization for cache keys (`cache.arch_cache_key`
        duck-types on this). Embeds the chip fingerprint plus every
        solver-relevant mesh field — chip count, topology, link bandwidth /
        hop latency / link energy. Excludes ``name`` (same contract as
        `arch.arch_fingerprint`)."""
        lk = self.link
        return (f"mesh[{arch_fingerprint(self.chip)}]"
                f"|n{self.n_chips}|{self.topology}"
                f"|lb{lk.bandwidth_bits}|hl{lk.hop_latency_cycles}"
                f"|le{lk.energy_pj_per_byte!r}")


def make_mesh(chip: CimArch | None = None, n_chips: int = 1, *,
              link: MeshLink | None = None, topology: str = "ring",
              name: str | None = None) -> MeshArch:
    """Convenience constructor with Table-IV chip defaults."""
    chip = chip or default_arch()
    link = link or MeshLink()
    if name is None:
        name = f"mesh-{chip.name}-n{n_chips}-{topology}"
    mesh = MeshArch(chip=chip, n_chips=n_chips, link=link,
                    topology=topology, name=name)
    mesh.validate()
    return mesh


# ---------------------------------------------------------------------------
# Residency capacity (the feasibility question the mesh exists to answer)
# ---------------------------------------------------------------------------

def total_macro_bytes(mesh: MeshArch) -> int:
    """Weight-resident capacity of the whole mesh."""
    from repro_torch.core.scheduler import chip_macro_bytes
    return mesh.n_chips * chip_macro_bytes(mesh.chip)


def residency_feasible(layers: Sequence[wl.Layer],
                       counts: Sequence[int] | None,
                       mesh: MeshArch) -> bool:
    """Can the whole network's distinct weight sets be macro-resident at
    once? Counts are distinct weight sets (depth repeats — the scheduler's
    convention). This is the benchmark's infeasible-on-one-chip /
    feasible-on-four criterion, not an execution gate: an infeasible
    network still *runs* (weights stream), it just can't stay resident."""
    counts = [1] * len(layers) if counts is None else list(counts)
    need = sum(int(c) * layer.operand_elems(WEIGHT)
               for layer, c in zip(layers, counts))
    return need <= total_macro_bytes(mesh)


# ---------------------------------------------------------------------------
# Shard choices + inter-chip transfer model
# ---------------------------------------------------------------------------

def shard_sub_layer(layer: wl.Layer, choice: str, n_chips: int) -> wl.Layer:
    """The per-chip sub-layer a shard choice executes: the split dim is
    divided by ``n_chips`` (validity checked by `shard_choices`);
    ``replicate`` is the layer itself. The name is display-only —
    structural identity (`cache.layer_cache_key`) covers bounds + stride."""
    if choice == REPLICATE or n_chips <= 1:
        return layer
    d = SPLIT_DIM[choice]
    assert layer.bound(d) % n_chips == 0, (layer.name, choice, n_chips)
    dims = {k: layer.bound(k) for k in wl.DIMS}
    dims[d] = dims[d] // n_chips
    return wl.Layer(f"{layer.name}~{choice}{n_chips}", dims,
                    stride=layer.stride, op=layer.op,
                    weight_written=layer.weight_written)


def shard_choices(layer: wl.Layer, mesh: MeshArch, *,
                  n_heads: int | None = None,
                  n_experts: int | None = None) -> tuple[str, ...]:
    """Valid shard choices for one layer on this mesh, in preference
    order. Divisibility discipline delegates to the sharding rules
    (`sharding.rules.mesh_tp_choices` — the same logical-axis fallbacks
    `make_plan` applies per tensor class), so attention heads that do not
    divide the mesh and MoE ``E % n != 0`` banks fall back to valid
    chip-replicated placements instead of raising. Always contains
    ``replicate``.

    Weight-grad GEMMs (`workload.OP_WGRAD`) resolve through the FSDP
    gradient rule instead (`sharding.rules.mesh_grad_choices`): split_n
    is the FSDP sharded-gradient layout (each chip owns a 1/n grad shard
    along the weight's output channels), split_k is data-parallel wGrad
    over the token reduction dim with a ring all-reduce of the fp32
    partial gradients (`shard_eval` already prices split_k's all-reduce
    at accumulator width — exactly the DP gradient sync)."""
    from repro_torch.sharding.rules import mesh_grad_choices, mesh_tp_choices
    if layer.op == wl.OP_WGRAD:
        return mesh_grad_choices(mesh.n_chips,
                                 out_channels=layer.bound("K"),
                                 reduce_dim=layer.bound("C"))
    return mesh_tp_choices(mesh.n_chips,
                           out_channels=layer.bound("K"),
                           reduce_dim=layer.bound("C"),
                           n_heads=n_heads, n_experts=n_experts)


@dataclasses.dataclass(frozen=True)
class ShardEval:
    """One shard choice's communication bill for one layer execution."""

    choice: str
    sub_layer: wl.Layer
    n_active: int            # chips computing (chip-energy multiplier)
    comm_cycles: float       # per-execution inter-chip transfer cycles
    comm_energy_pj: float    # per-execution link energy


def shard_eval(layer: wl.Layer, choice: str, mesh: MeshArch) -> ShardEval:
    """Eq. 9-style transfer term of one shard choice: sharded operand
    bytes (and all-reduce volume) over the link bandwidth, charged per hop
    count of the topology.

      * replicate — no inter-chip traffic (the host chip holds everything).
      * split_n   — every chip needs the full input (broadcast from the
        host over ``bcast_hops``) and returns its 1/n output slice
        (gather: ``(n-1)/n`` of the output travels back, at
        `out_bytes_per_elem` width — fp32 for wGrad gradients).
      * split_k   — every chip needs its 1/n input slice (scatter:
        ``(n-1)/n`` of the input leaves the host) and the 32-bit partial
        outputs ring-all-reduce (2(n-1) steps of 1/n chunks).

    Link energy is per byte per hop (`MeshLink.energy_pj_per_byte`); the
    all-reduce moves ``2(n-1) * bytes/n`` over single-hop ring steps.
    Every term is monotone non-increasing in the link bandwidth, so the
    per-layer mesh record — the min over choices of (chip + comm) — is
    too (`tests/test_mesh.py` fuzzes this)."""
    n = mesh.n_chips
    sub = shard_sub_layer(layer, choice, n)
    if choice == REPLICATE or n <= 1:
        return ShardEval(REPLICATE, layer, 1, 0.0, 0.0)
    link, hops = mesh.link, mesh.bcast_hops()
    in_bytes = layer.operand_elems(INPUT) * ACT_BYTES
    out_bytes = layer.operand_elems(OUTPUT) * out_bytes_per_elem(layer)
    e = link.energy_pj_per_byte
    if choice == SPLIT_N:
        gather = out_bytes * (n - 1) / n
        cycles = (link_transfer_cycles(in_bytes, link, hops) +
                  link_transfer_cycles(gather, link, hops))
        energy = e * (in_bytes + gather) * hops
        return ShardEval(choice, sub, n, cycles, energy)
    assert choice == SPLIT_K, choice
    scatter = in_bytes * (n - 1) / n
    ar_bytes = layer.operand_elems(OUTPUT) * PSUM_BYTES
    cycles = (link_transfer_cycles(scatter, link, hops) +
              ring_allreduce_cycles(ar_bytes, link, n))
    energy = e * (scatter * hops + 2 * (n - 1) * (ar_bytes / n))
    return ShardEval(choice, sub, n, cycles, energy)


def best_shard(layer: wl.Layer, mesh: MeshArch, sub_records: dict, *,
               choices: Sequence[str] | None = None
               ) -> tuple[ShardEval, dict]:
    """Pick the cheapest shard choice given solved sub-layer records
    (``sub_records``: `layer_cache_key`(sub layer) -> chip record).
    Selection is argmin by (total cycles, total energy, choice order) —
    cycles first so the per-layer number stays monotone in the link
    bandwidth (a min of monotone per-choice curves)."""
    from repro_torch.core.cache import layer_cache_key
    best = None
    for idx, choice in enumerate(choices or
                                 shard_choices(layer, mesh)):
        ev = shard_eval(layer, choice, mesh)
        rec = sub_records[layer_cache_key(ev.sub_layer)]
        cyc = rec["cycles"] + ev.comm_cycles
        pj = ev.n_active * rec["energy_pj"] + ev.comm_energy_pj
        if best is None or (cyc, pj, idx) < best[:3]:
            best = (cyc, pj, idx, ev, rec)
    assert best is not None
    _, _, _, ev, rec = best
    return ev, rec


def _mesh_record(layer: wl.Layer, ev: ShardEval, sub_rec: dict,
                 mode: str) -> dict:
    """Combine a chip record + a shard's comm bill into one mesh record.
    The record keeps the single-chip schema (cycles/energy_pj/edp/mapping
    — the mapping is the *sub-layer's*) and adds the mesh fields the
    scheduler and the reports read."""
    cycles = sub_rec["cycles"] + ev.comm_cycles
    energy = ev.n_active * sub_rec["energy_pj"] + ev.comm_energy_pj
    return {
        "mode": mode,
        "layer": layer.name,
        "mapping": sub_rec["mapping"],
        "cycles": cycles,
        "energy_pj": energy,
        "edp": cycles * energy,
        "spatial_util": sub_rec["spatial_util"],
        "temporal_util": sub_rec["temporal_util"],
        "solve_s": sub_rec.get("solve_s", 0.0),
        "status": sub_rec["status"],
        # mesh-only fields ---------------------------------------------------
        "chip_cycles": sub_rec["cycles"],
        "chip_energy_pj": sub_rec["energy_pj"],
        "comm_cycles": ev.comm_cycles,
        "comm_energy_pj": ev.comm_energy_pj,
        "shard": {
            "choice": ev.choice,
            "n_chips": ev.n_active if ev.choice != REPLICATE else 1,
            "n_active": ev.n_active,
            "sub_dims": {d: ev.sub_layer.bound(d) for d in wl.DIMS},
        },
    }


# ---------------------------------------------------------------------------
# Mesh network pipeline
# ---------------------------------------------------------------------------

def optimize_mesh_network(layers: Sequence[wl.Layer], mesh: MeshArch,
                          mode: str = "miredo", *,
                          counts: Sequence[int] | None = None,
                          cfg=None,
                          total_budget_s: float | None = None,
                          per_layer_cap_s: float = 60.0,
                          workers: int | None = None,
                          cache=None,
                          use_cache: bool = True,
                          schedule: bool = True,
                          schedule_boundaries: Sequence[int] | None = None,
                          warm_starts: dict[str, dict] | None = None,
                          portfolio=None,
                          verbose: bool = False):
    """Mesh counterpart of `network.optimize_network` (which dispatches
    here for ``mesh=`` with ``n_chips > 1``; a 1-chip mesh takes the
    single-chip path bit for bit and never reaches this function).

    Per unique layer, every valid shard's sub-layer is solved through ONE
    inner single-chip `optimize_network` call against ``mesh.chip``
    (``schedule=False``): structural dedup across layers AND shard
    choices, MAC-weighted budgets over the full sub-layer pool, process
    fan-out and chip-keyed record caching all come for free. The combined
    per-layer mesh records cache under the **mesh** fingerprint
    (CACHE_VERSION 6 arch key), so a rerun with every mesh record present
    skips the inner call entirely; any miss re-runs the inner call over
    the FULL sub-layer pool — budget allocation is over the same pool
    regardless of cache state, so budgets (and hence chip cache keys) are
    rerun-deterministic, mirroring the single-chip pipeline's discipline.

    Returns a `network.NetworkResult` with ``arch_name = mesh.name``;
    ``scheduled``/``schedule`` come from the mesh scheduler
    (`scheduler.schedule_mesh`: one-hot (chip, core) placement MIP with
    per-chip residency, greedy water-filling fallback)."""
    from repro_torch.core.cache import (ResultCache, layer_cache_key,
                                  solve_record_key)
    from repro_torch.core.formulation import FormulationConfig
    from repro_torch.core.network import (DEFAULT_BUDGET_FRACTION, LayerResult,
                                    NetworkResult, _aggregate, dedup_layers,
                                    optimize_network)

    assert mesh.n_chips > 1, "1-chip meshes take the single-chip path"
    t0 = time.monotonic()
    layers = list(layers)
    counts = [1] * len(layers) if counts is None else list(counts)
    assert len(counts) == len(layers)
    base_cfg = cfg or FormulationConfig(time_limit_s=per_layer_cap_s)
    cache = cache if cache is not None else (
        ResultCache() if use_cache else None)

    unique, keys = dedup_layers(layers)

    # ---- candidate sub-layers per unique layer ----------------------------
    cands: dict[str, list[tuple[str, wl.Layer]]] = {}
    pool: list[wl.Layer] = []
    pool_seen: set[str] = set()
    for ul in unique:
        k = layer_cache_key(ul)
        cands[k] = [(c, shard_sub_layer(ul, c, mesh.n_chips))
                    for c in shard_choices(ul, mesh)]
        for _, sub in cands[k]:
            sk = layer_cache_key(sub)
            if sk not in pool_seen:
                pool_seen.add(sk)
                pool.append(sub)

    # Mesh-record cache probe. The cfg component of the mesh key carries
    # the *resolved global budget* (deterministic from the inputs) — the
    # per-sub-layer budgets the inner call derives are a pure function of
    # it and the pool, so the mesh key fully determines the solve.
    if total_budget_s is None:
        total_budget_s = (DEFAULT_BUDGET_FRACTION * per_layer_cap_s *
                          len(pool))
    mesh_cfg = dataclasses.replace(base_cfg, time_limit_s=total_budget_s)
    mesh_key = {k: solve_record_key(mode, ul, mesh, mesh_cfg,
                                    portfolio=portfolio)
                for ul, k in ((u, layer_cache_key(u)) for u in unique)}
    records: dict[str, dict] = {}
    if cache is not None:
        for ul in unique:
            k = layer_cache_key(ul)
            rec = cache.get(mesh_key[k])
            if rec is not None:
                records[k] = rec
    cache_hits = len(records)
    budgets: dict[str, float] = {}

    # ---- inner single-chip pass over the full pool on any miss ------------
    if len(records) < len(unique):
        inner = optimize_network(
            pool, mesh.chip, mode, cfg=base_cfg,
            total_budget_s=total_budget_s,
            per_layer_cap_s=per_layer_cap_s, workers=workers,
            cache=cache, use_cache=use_cache, schedule=False,
            warm_starts=warm_starts, portfolio=portfolio,
            verbose=verbose)
        sub_records = {lr.key: lr.record for lr in inner.layers}
        budgets = inner.budgets
        for ul in unique:
            k = layer_cache_key(ul)
            if k in records:
                continue
            ev, sub_rec = best_shard(
                ul, mesh, sub_records,
                choices=[c for c, _ in cands[k]])
            rec = _mesh_record(ul, ev, sub_rec, mode)
            records[k] = rec
            if cache is not None:
                cache.put(mesh_key[k], rec)
            if verbose:
                print(f"[mesh/{mode}] {ul.name}: {rec['shard']['choice']} "
                      f"-> {rec['cycles']:.3g} cyc "
                      f"({rec['comm_cycles']:.3g} comm)")

    # ---- per-instance results ---------------------------------------------
    out_layers: list[LayerResult] = []
    for layer, count, k in zip(layers, counts, keys):
        rec = dict(records[k])
        rec["layer"] = layer.name
        out_layers.append(LayerResult(layer=layer, count=int(count), key=k,
                                      record=rec))

    totals = _aggregate(out_layers)
    scheduled = sched = None
    if schedule:
        from repro_torch.core.scheduler import schedule_mesh
        sched = schedule_mesh(out_layers, mesh,
                              boundaries=schedule_boundaries,
                              verbose=verbose)
        scheduled = sched.totals()
        scheduled["energy_pj"] = totals["energy_pj"] + sched.energy_delta_pj
        scheduled["edp"] = scheduled["energy_pj"] * sched.scheduled_cycles

    return NetworkResult(
        mode=mode, arch_name=mesh.name, layers=out_layers,
        n_unique=len(unique), n_solved=len(unique) - cache_hits,
        cache_hits=cache_hits, budgets=budgets,
        wall_s=round(time.monotonic() - t0, 2),
        totals=totals, scheduled=scheduled, schedule=sched)
