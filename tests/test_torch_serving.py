"""The port's copy of the request-level serving simulator
(`repro_torch.core.serving`) and ``serve_lm --traffic`` against the JAX
package's (`repro.core.serving`, the demo's ``traffic_demo``). The
simulator is plain Python over the optimizer, so the event logs,
per-request metrics and summaries must be equal, not close: every float
is compared with ``==``."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_config
from repro.core import serving as ref
from repro.core.arch import default_arch as ref_default_arch
from repro_torch import serve_lm
from repro_torch.configs import get_config
from repro_torch.core import serving
from repro_torch.core.arch import default_arch


def _same_report(got, want):
    assert got.events == want.events
    assert got.summary(1.5) == want.summary(1.5)
    assert [dataclasses.astuple(m) for m in got.finished] == \
        [dataclasses.astuple(m) for m in want.finished]
    assert got.rejected == want.rejected
    assert dataclasses.astuple(got.cfg) == dataclasses.astuple(want.cfg)


def _serve_cfgs(mod, admission):
    # a small KV capacity: the optimistic policy preempts and requeues,
    # and the largest requests of the stream are rejected up front
    return mod.ServeConfig(kv_capacity_tokens=40, max_batch_requests=6,
                           max_batch_tokens=48, admission=admission,
                           slo_ttft_cycles=4e5, slo_itl_cycles=9e4)


@pytest.mark.parametrize("admission", ["reserve", "optimistic"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulator_matches_reference_affine(seed, admission):
    """Seeded Poisson streams under the affine cost model: the
    continuous-batching run and the serial baseline equal the
    reference's, event for event."""
    kw = dict(seed=seed, mean_interarrival_cycles=30_000.0,
              prompt_lens=(4, 12, 30), output_lens=(2, 9, 20))
    stream, rstream = (mod.RequestStream.poisson(24, **kw)
                       for mod in (serving, ref))
    assert [dataclasses.astuple(r) for r in stream.requests] == \
        [dataclasses.astuple(r) for r in rstream.requests]
    cost = serving.AffineCostModel(base=20_000.0, per_token=700.0)
    rcost = ref.AffineCostModel(base=20_000.0, per_token=700.0)
    cfg, rcfg = (_serve_cfgs(mod, admission) for mod in (serving, ref))
    rep = serving.simulate_serving(stream, cost, cfg)
    _same_report(rep, ref.simulate_serving(rstream, rcost, rcfg))
    _same_report(serving.serial_baseline(stream, cost, cfg),
                 ref.serial_baseline(rstream, rcost, rcfg))
    if admission == "optimistic":
        assert rep.n_preemptions > 0
    assert rep.rejected


def test_simulator_matches_reference_network_cost():
    """Reduced minicpm-2b under the network cost model (greedy solves of
    the copied optimizer, scheduled cycles): the anchors and every
    iteration cost up to max_m equal the reference's, and so does a
    served stream."""
    kw = dict(max_m=32, context_len=128, mode="greedy")
    cost = serving.NetworkCostModel(get_config("minicpm-2b").reduced(),
                                    default_arch(), **kw)
    rcost = ref.NetworkCostModel(ref_config("minicpm-2b").reduced(),
                                 ref_default_arch(), **kw)
    assert [cost.cycles(m) for m in range(33)] == \
        [rcost.cycles(m) for m in range(33)]
    assert cost.anchor_cycles == rcost.anchor_cycles
    assert cost.n_solves == rcost.n_solves
    scfg = dict(kv_capacity_tokens=256, max_batch_requests=8,
                max_batch_tokens=32)
    stream_kw = dict(seed=3, mean_interarrival_cycles=80_000.0)
    _same_report(
        serving.simulate_serving(serving.RequestStream.poisson(12,
                                                               **stream_kw),
                                 cost, serving.ServeConfig(**scfg)),
        ref.simulate_serving(ref.RequestStream.poisson(12, **stream_kw),
                             rcost, ref.ServeConfig(**scfg)))


def test_serve_lm_traffic_matches_reference_demo(capsys):
    """``serve_lm --traffic --n-requests 8`` returns the continuous-
    batching and serial reports of the reference's ``traffic_demo``
    (`examples/serve_lm.py:102-134`), computed here with the reference's
    functions on its reduced glm4-9b, and prints the demo's lines."""
    rep, ser = serve_lm.main(["--traffic", "--n-requests", "8"])
    serve_cfg = ref.ServeConfig(kv_capacity_tokens=512,
                                max_batch_requests=16, max_batch_tokens=128)
    cost = ref.NetworkCostModel(ref_config("glm4-9b").reduced(),
                                ref_default_arch(),
                                max_m=serve_cfg.max_batch_tokens,
                                context_len=256, mode="greedy")
    stream = ref.RequestStream.poisson(8, seed=0,
                                       mean_interarrival_cycles=150_000.0)
    _same_report(rep, ref.simulate_serving(stream, cost, serve_cfg))
    _same_report(ser, ref.serial_baseline(stream, cost, serve_cfg))
    assert rep.makespan_cycles <= ser.makespan_cycles
    out = capsys.readouterr().out
    assert "served 8 requests on" in out and "continuous batching:" in out


def test_percentile_and_trace_match_reference(tmp_path):
    values = [5.0, 1.0, 9.0, 3.0, 3.0, 7.0, 2.0]
    for q in (0, 1, 25, 50, 90, 99, 100):
        assert serving.percentile(values, q) == ref.percentile(values, q)
    path = tmp_path / "trace.txt"
    path.write_text("# arrival prompt output\n30 8 4\n10, 16, 2\n\n20 4 1\n")
    got, want = serving.RequestStream.from_trace(str(path)), \
        ref.RequestStream.from_trace(str(path))
    assert [dataclasses.astuple(r) for r in got.requests] == \
        [dataclasses.astuple(r) for r in want.requests]
    assert got.source == want.source


def test_copy_differs_from_the_reference_only_in_import_paths():
    """`core/serving.py` is the reference's module with its imports
    pointed at the port's own copies, and nothing else changed."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "src"
    port = (root / "repro_torch" / "core" / "serving.py").read_text()
    want = (root / "repro" / "core" / "serving.py").read_text()
    assert port.replace("from repro_torch.", "from repro.") == want
    assert "from repro." not in port
