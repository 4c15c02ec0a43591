"""The port's mesh pipeline and co-design DSE against the JAX package's:
the sharding rules' mesh choices (`repro_torch.sharding.rules`), the
mesh model (`core/mesh.py`), the scheduler's mesh half
(`core/scheduler.py`), `optimize_network(mesh=...)` and `core/dse.py`.
All of it is host code copied from the reference, so every comparison
is exact: cycles and energies with ==, records as dicts, schedules as
dataclass trees.

Greedy solves are deterministic and run on both sides. MIP solves are
time-capped and jitter under load (HiGHS is anytime), so the MIP-fidelity
passes are compared through a shared solve cache: the reference solves
into it and the port must find every record there, solving nothing.
No hypothesis search: the cases are fixed and small (the reference's
mesh property tests take 5-25 s a case)."""

import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.core import arch as rarch
from repro.core import cache as rcache
from repro.core import dse as rdse
from repro.core import mesh as rmesh
from repro.core import network as rnetwork
from repro.core import scheduler as rscheduler
from repro.core import workload as rwl
from repro.sharding import rules as rrules
from repro_torch.core import arch, dse, mesh, network, scheduler
from repro_torch.core import workload as wl
from repro_torch.core.cache import ResultCache
from repro_torch.sharding import rules

CHIPS = (1, 2, 3, 4, 8)
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 36, 60)
HEADS = (None, 0, 4, 6, 36)
EXPERTS = (None, 0, 4, 6, 60)
#: Small GEMMs whose dims split by 2 and 4 (both TP splits stay
#: available), one that splits by neither, and a weight-grad GEMM.
GEMMS = [("g0", 8, 16, 32, "gemm"), ("g1", 8, 32, 16, "gemm"),
         ("g2", 8, 16, 16, "gemm"), ("g3", 24, 48, 96, "gemm"),
         ("odd", 6, 9, 15, "gemm"), ("wg", 32, 16, 8, "wgrad")]
COUNTS = [1, 1, 2, 1, 3, 1]


def _layers(mod):
    return [mod.gemm(n, m, k, c, op=op) for n, m, k, c, op in GEMMS]


def _tree(x):
    """A dataclass tree as plain data, layers by their structure."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return x


def _meshes(n_chips, topology="ring", bits=None):
    link = {} if bits is None else {"bandwidth_bits": bits}
    return (mesh.make_mesh(arch.default_arch(), n_chips, topology=topology,
                           link=arch.MeshLink(**link)),
            rmesh.make_mesh(rarch.default_arch(), n_chips, topology=topology,
                            link=rarch.MeshLink(**link)))


def test_rules_constants_identical():
    assert (rules.m_REPLICATE, rules.m_SPLIT_N, rules.m_SPLIT_K) == \
        (rrules.m_REPLICATE, rrules.m_SPLIT_N, rrules.m_SPLIT_K) == \
        (mesh.REPLICATE, mesh.SPLIT_N, mesh.SPLIT_K)


@pytest.mark.parametrize("n_chips", CHIPS)
def test_tp_choices_match_reference(n_chips):
    for out, red, heads, experts in itertools.product(DIMS, DIMS, HEADS,
                                                      EXPERTS):
        kw = dict(out_channels=out, reduce_dim=red, n_heads=heads,
                  n_experts=experts)
        assert rules.mesh_tp_choices(n_chips, **kw) == \
            rrules.mesh_tp_choices(n_chips, **kw), (n_chips, kw)


@pytest.mark.parametrize("n_chips", CHIPS)
def test_grad_choices_match_reference(n_chips):
    for out, red in itertools.product(DIMS, DIMS):
        kw = dict(out_channels=out, reduce_dim=red)
        assert rules.mesh_grad_choices(n_chips, **kw) == \
            rrules.mesh_grad_choices(n_chips, **kw), (n_chips, kw)


@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_make_mesh_matches_reference(topology):
    for n in (1, 2, 3, 4, 6, 8, 9):
        for bits in (None, 32, 1024):
            ours, ref = _meshes(n, topology, bits)
            assert ours.name == ref.name
            assert ours.fingerprint() == ref.fingerprint()
            assert ours.grid_dims() == ref.grid_dims()
            assert ours.bcast_hops() == ref.bcast_hops()
            assert [ours.chip_distance(a, b) for a in range(n)
                    for b in range(n)] == \
                [ref.chip_distance(a, b) for a in range(n) for b in range(n)]
            assert mesh.total_macro_bytes(ours) == \
                rmesh.total_macro_bytes(ref)
            assert mesh.residency_feasible(_layers(wl), COUNTS, ours) == \
                rmesh.residency_feasible(_layers(rwl), COUNTS, ref)


@pytest.mark.parametrize("n_chips", [1, 2, 4])
@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_shard_choices_and_eval_match_reference(n_chips, topology):
    ours_mesh, ref_mesh = _meshes(n_chips, topology)
    for ours, ref in zip(_layers(wl), _layers(rwl)):
        for kw in ({}, {"n_heads": 4}, {"n_heads": 3}, {"n_experts": 8},
                   {"n_experts": 6}):
            choices = mesh.shard_choices(ours, ours_mesh, **kw)
            assert choices == rmesh.shard_choices(ref, ref_mesh, **kw)
            for choice in choices:
                a = mesh.shard_eval(ours, choice, ours_mesh)
                b = rmesh.shard_eval(ref, choice, ref_mesh)
                assert _tree(a) == _tree(b), (ours.name, choice)


def _net_pair(n_chips, mode="greedy", **kw):
    ours_mesh, ref_mesh = _meshes(n_chips)
    a = network.optimize_network(_layers(wl), None, mode, mesh=ours_mesh,
                                 counts=COUNTS, workers=1, **kw)
    b = rnetwork.optimize_network(_layers(rwl), None, mode, mesh=ref_mesh,
                                  counts=COUNTS, workers=1, **kw)
    return a, b


def _assert_nets_equal(a, b):
    assert a.arch_name == b.arch_name and a.mode == b.mode
    assert len(a.layers) == len(b.layers)
    for x, y in zip(a.layers, b.layers):
        assert x.layer.name == y.layer.name and x.count == y.count
        assert x.record == y.record
    assert a.totals == b.totals
    assert a.scheduled == b.scheduled
    assert _tree(a.schedule) == _tree(b.schedule)


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_optimize_network_on_a_mesh_matches_reference(n_chips):
    """Greedy solves on 1-, 2- and 4-chip meshes: records, totals and
    the (chip, core) schedule equal; a 1-chip mesh is its chip."""
    a, b = _net_pair(n_chips, use_cache=False)
    _assert_nets_equal(a, b)
    if n_chips == 1:
        single = network.optimize_network(_layers(wl), arch.default_arch(),
                                          "greedy", counts=COUNTS,
                                          use_cache=False, workers=1)
        _assert_nets_equal(a, single)
    else:
        assert all("shard" in lr.record for lr in a.layers)


def test_mesh_schedule_and_replay_match_reference():
    """`schedule_mesh` with the placement MIP and with greedy
    water-filling, and `cross_check_mesh`'s event replay, on the same
    records."""
    for n_chips in (2, 4):
        ours_mesh, ref_mesh = _meshes(n_chips)
        a = network.optimize_network(_layers(wl)[:4], None, "greedy",
                                     mesh=ours_mesh, counts=COUNTS[:4],
                                     use_cache=False, workers=1,
                                     schedule=False)
        b = rnetwork.optimize_network(_layers(rwl)[:4], None, "greedy",
                                      mesh=ref_mesh, counts=COUNTS[:4],
                                      use_cache=False, workers=1,
                                      schedule=False)
        for use_mip in (True, False):
            sa = scheduler.schedule_mesh(a.layers, ours_mesh,
                                         use_mip=use_mip)
            sb = rscheduler.schedule_mesh(b.layers, ref_mesh,
                                          use_mip=use_mip)
            assert _tree(sa) == _tree(sb), (n_chips, use_mip)
        assert scheduler.cross_check_mesh(sa, ours_mesh) == \
            rscheduler.cross_check_mesh(sb, ref_mesh)


def test_mesh_mip_records_come_from_the_reference_cache(tmp_path,
                                                        monkeypatch):
    """The MIP-fidelity mesh pass: the reference solves a 2-chip mesh into
    a cache directory; the port finds every record there, solves
    nothing, and returns the reference's records and schedule."""
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    ours_mesh, ref_mesh = _meshes(2)
    layers = slice(0, 3)
    b = rnetwork.optimize_network(_layers(rwl)[layers], None, "miredo",
                                  mesh=ref_mesh, counts=COUNTS[layers],
                                  per_layer_cap_s=0.5, workers=1)
    assert b.n_solved > 0
    a = network.optimize_network(_layers(wl)[layers], None, "miredo",
                                 mesh=ours_mesh, counts=COUNTS[layers],
                                 per_layer_cap_s=0.5, workers=1)
    assert a.n_solved == 0 and a.cache_hits == b.n_solved + b.cache_hits
    _assert_nets_equal(a, b)


def _space(mod):
    return mod.ArchSpace(macro=((64, 32), (128, 32)), n_cores=(2,),
                         lbuf_kb=(256.0, 2.0), prefix="t")


DSE_LAYERS = [("a", 32, 64, 64), ("b", 128, 2048, 64)]


def _assert_dse_equal(a, b):
    assert sorted(a.archs) == sorted(b.archs)
    assert a.survivors == b.survivors and a.pruned == b.pruned
    assert _tree(a.screen_points) == _tree(b.screen_points)
    assert _tree(a.points) == _tree(b.points)
    assert _tree(a.frontier) == _tree(b.frontier)
    assert a.validation == b.validation
    assert sorted(a.networks) == sorted(b.networks)
    for name in a.networks:
        _assert_nets_equal(a.networks[name], b.networks[name])
    assert a.prune_fraction == b.prune_fraction


def test_run_dse_greedy_matches_reference():
    a = dse.run_dse([wl.gemm(*l) for l in DSE_LAYERS], [2, 1], _space(dse),
                    "greedy", screen_samples=8, use_cache=False, workers=1)
    b = rdse.run_dse([rwl.gemm(*l) for l in DSE_LAYERS], [2, 1],
                     _space(rdse), "greedy", screen_samples=8,
                     use_cache=False, workers=1)
    _assert_dse_equal(a, b)
    assert a.frontier and all(not e for e in a.validation.values())
    best = a.best_under_area(min(p.area_bits for p in a.frontier))
    assert _tree(best) == _tree(b.best_under_area(
        min(p.area_bits for p in b.frontier)))


def test_screen_arch_matches_reference():
    ours = dse.screen_arch(dse._screen_subset(
        [wl.gemm(*l) for l in DSE_LAYERS], [2, 1]), arch.default_arch(),
        samples=8)
    ref = rdse.screen_arch(rdse._screen_subset(
        [rwl.gemm(*l) for l in DSE_LAYERS], [2, 1]), rarch.default_arch(),
        samples=8)
    assert _tree(ours) == _tree(ref)


def test_run_dse_mip_fidelity_from_the_reference_cache(tmp_path):
    """The DSE's MIP pass: the reference's exhaustive run solves into a
    shared cache; the port's run over the same grid finds every record,
    solves nothing, and returns the reference's frontier."""
    b = rdse.run_dse([rwl.gemm(*l) for l in DSE_LAYERS], [2, 1],
                     _space(rdse), "miredo", screen=False,
                     per_layer_cap_s=0.5, workers=1,
                     cache=rcache.ResultCache(str(tmp_path)))
    a = dse.run_dse([wl.gemm(*l) for l in DSE_LAYERS], [2, 1], _space(dse),
                    "miredo", screen=False, per_layer_cap_s=0.5, workers=1,
                    cache=ResultCache(str(tmp_path)))
    assert all(net.n_solved == 0 for net in a.networks.values())
    _assert_dse_equal(a, b)


def test_run_mesh_dse_matches_reference():
    """`run_mesh_dse` over a chip-count x link grid, greedy."""
    space = dict(n_chips=(1, 2), link_bits=(64, 256))
    ours_space = dse.MeshSpace(**space)
    ref_space = rdse.MeshSpace(**space)
    a = dse.run_mesh_dse(_layers(wl)[:3], COUNTS[:3], ours_space,
                         "greedy", use_cache=False, workers=1)
    b = rdse.run_mesh_dse(_layers(rwl)[:3], COUNTS[:3], ref_space,
                          "greedy", use_cache=False, workers=1)
    _assert_dse_equal(a, b)
    assert [m.fingerprint() for m in a.archs.values()] == \
        [m.fingerprint() for m in b.archs.values()]
