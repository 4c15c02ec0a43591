"""The port's own copy of the optimizer (`repro_torch.core`,
`repro_torch.configs`) against the JAX package's: the same workloads,
the same greedy solves and schedules, and solve records carried across
through the shared cache format (`MIREDO_CACHE`)."""

import json

import pytest

pytest.importorskip("torch")

import repro.configs as ref_configs
import repro.core.frontend as ref_frontend
import repro.core.network as ref_network
from repro.core.arch import default_arch as ref_default_arch
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.arch import default_arch
from repro_torch.core.cache import CACHE_VERSION, ResultCache
from repro_torch.core.frontend import extract_workload
from repro_torch.core.network import optimize_network

MODELS = ("minicpm-2b", "glm4-9b", "mamba2-1.3b")
SPECS = {"prefill": ShapeSpec("t_prefill", seq_len=64, global_batch=1,
                              kind="prefill"),
         "decode": ShapeSpec("t_decode", seq_len=64, global_batch=4,
                             kind="decode")}


def _pair(aid, scen):
    spec = SPECS[scen]
    cfg = get_config(aid).reduced()
    rcfg = ref_configs.get_config(aid).reduced()
    rspec = ref_configs.ShapeSpec(spec.name, seq_len=spec.seq_len,
                                  global_batch=spec.global_batch,
                                  kind=spec.kind)
    return (cfg, spec), (rcfg, rspec)


def _layer_sig(layer):
    return (layer.name, layer.op, tuple(sorted(layer.dims.items())),
            layer.stride, layer.weight_written)


def test_registry_and_shapes_match():
    assert ARCH_IDS == ref_configs.ARCH_IDS
    assert set(SHAPES) == set(ref_configs.SHAPES)
    for name, spec in SHAPES.items():
        r = ref_configs.SHAPES[name]
        assert (spec.seq_len, spec.global_batch, spec.kind) == \
            (r.seq_len, r.global_batch, r.kind)
    for aid in ARCH_IDS:
        assert repr(get_config(aid)) == repr(ref_configs.get_config(aid))


@pytest.mark.parametrize("aid", MODELS)
@pytest.mark.parametrize("scen", sorted(SPECS))
def test_extract_workload_matches(aid, scen):
    (cfg, spec), (rcfg, rspec) = _pair(aid, scen)
    work = extract_workload(cfg, spec)
    ref = ref_frontend.extract_workload(rcfg, rspec)
    assert [_layer_sig(l) for l in work.layers] == \
        [_layer_sig(l) for l in ref.layers]
    assert list(work.counts) == list(ref.counts)
    assert work.n_unique == ref.n_unique


@pytest.mark.parametrize("aid", MODELS)
@pytest.mark.parametrize("scen", sorted(SPECS))
def test_greedy_network_matches(aid, scen):
    """Greedy solves are deterministic: equal records (cycles compared
    with ==, mappings as JSON) and equal scheduled totals."""
    (cfg, spec), (rcfg, rspec) = _pair(aid, scen)
    work = extract_workload(cfg, spec)
    ref = ref_frontend.extract_workload(rcfg, rspec)
    net = optimize_network(list(work.layers), default_arch(), "greedy",
                           counts=list(work.counts), use_cache=False,
                           workers=1)
    rnet = ref_network.optimize_network(list(ref.layers), ref_default_arch(),
                                        "greedy", counts=list(ref.counts),
                                        use_cache=False, workers=1)
    assert len(net.layers) == len(rnet.layers)
    for a, b in zip(net.layers, rnet.layers):
        assert a.layer.name == b.layer.name and a.count == b.count
        assert a.record["cycles"] == b.record["cycles"]
        assert a.record["energy_pj"] == b.record["energy_pj"]
        assert json.dumps(a.record["mapping"], sort_keys=True) == \
            json.dumps(b.record["mapping"], sort_keys=True)
    assert net.totals == rnet.totals
    assert net.scheduled == rnet.scheduled


def test_records_written_by_reference_are_port_cache_hits(tmp_path,
                                                          monkeypatch):
    """State carried across: MIP records the JAX package solved into a
    cache directory come back to the port as hits, equal, with nothing
    solved again. (Reduced glm4-9b decode: no 1x1x1 GEMM, which the
    shared MIP cannot take.)"""
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    (cfg, spec), (rcfg, rspec) = _pair("glm4-9b", "decode")
    ref = ref_frontend.extract_workload(rcfg, rspec)
    rnet = ref_network.optimize_network(list(ref.layers), ref_default_arch(),
                                        "miredo", counts=list(ref.counts),
                                        per_layer_cap_s=0.5, workers=1)
    assert rnet.n_solved == rnet.n_unique > 0
    assert ResultCache().directory == str(tmp_path)
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), default_arch(), "miredo",
                           counts=list(work.counts), per_layer_cap_s=0.5,
                           workers=1)
    assert net.n_solved == 0 and net.cache_hits == rnet.n_unique
    for a, b in zip(net.layers, rnet.layers):
        assert a.record == b.record
    assert net.totals == rnet.totals
    assert CACHE_VERSION == 8


def test_mesh_argument_is_not_ported():
    """The name is kept from when ``mesh=`` raised; the mesh pipeline is
    ported now, and ``mesh=`` gives the reference's result: reduced
    glm4-9b decode, greedy, on a 1-chip mesh (its chip, bit for bit) and
    a 2-chip mesh (sharded records and the (chip, core) schedule)."""
    from repro.core.mesh import make_mesh as ref_make_mesh
    from repro_torch.core.mesh import make_mesh
    (cfg, spec), (rcfg, rspec) = _pair("glm4-9b", "decode")
    work = extract_workload(cfg, spec)
    ref = ref_frontend.extract_workload(rcfg, rspec)
    for n_chips in (1, 2):
        net = optimize_network(list(work.layers), None, "greedy",
                               mesh=make_mesh(default_arch(), n_chips),
                               counts=list(work.counts), use_cache=False,
                               workers=1)
        rnet = ref_network.optimize_network(
            list(ref.layers), None, "greedy",
            mesh=ref_make_mesh(ref_default_arch(), n_chips),
            counts=list(ref.counts), use_cache=False, workers=1)
        assert net.arch_name == rnet.arch_name
        assert [a.record for a in net.layers] == \
            [b.record for b in rnet.layers]
        assert net.totals == rnet.totals
        assert net.scheduled == rnet.scheduled
        assert net.schedule.scheduled_cycles == rnet.schedule.scheduled_cycles
        assert [seg.mode for seg in net.schedule.segments] == \
            [seg.mode for seg in rnet.schedule.segments]
        assert all(("shard" in a.record) == (n_chips > 1)
                   for a in net.layers)


def test_batched_scorer_numpy_only():
    """Without a backend the scorer runs the NumPy loop, whatever the
    machine has; the reference's "jax" backend is refused with a pointer
    to the port's "torch" one."""
    from repro_torch.core import latency_batched as lb
    from repro_torch.core.baselines import greedy_mapping
    from repro_torch.core.latency import evaluate
    layer = extract_workload(*_pair("glm4-9b", "decode")[0]).layers[0]
    arch = default_arch()
    mp = greedy_mapping(layer, arch)
    sc = lb.score_mappings([mp], layer, arch)
    assert sc.cycles[0] == evaluate(mp, layer, arch).total_cycles
    with pytest.raises(ValueError, match='"torch"'):
        lb.score_mappings([mp], layer, arch, backend="jax")
