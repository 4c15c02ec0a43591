"""The port's measured-execution backend (`repro_torch/core/executor.py`)
against the reference's: the same plans from the same solves, and the
reduced slice executed on the CPU through the kernels' plain versions
(greedy solve mode — no MIP wall-clock in tier-1)."""

import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs
import repro.core.executor as ref_executor
import repro.core.frontend as ref_frontend
import repro.core.network as ref_network
from repro.core.arch import default_arch as ref_default_arch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.arch import default_arch
from repro_torch.core.executor import (DECODE_KV_CAP, EXEC_BLOCK_CAP,
                                       NUMERICS_TOL, execute_model,
                                       execute_plan, lower_plan, spearman)
from repro_torch.core.frontend import extract_workload
from repro_torch.core.network import optimize_network

PREFILL = ShapeSpec("t_prefill", seq_len=64, global_batch=1, kind="prefill")
DECODE = ShapeSpec("t_decode", seq_len=64, global_batch=4, kind="decode")
CASES = [("minicpm-2b", PREFILL), ("glm4-9b", DECODE),
         ("mamba2-1.3b", PREFILL), ("seamless-m4t-large-v2", DECODE)]


def _plans(aid, spec):
    """(port plan, reference plan) from greedy solves of the same reduced
    workload — deterministic, and equal record for record
    (tests/test_torch_optimizer.py)."""
    cfg = get_config(aid).reduced()
    work = extract_workload(cfg, spec)
    net = optimize_network(list(work.layers), default_arch(), "greedy",
                           counts=list(work.counts), use_cache=False,
                           workers=1)
    rcfg = ref_configs.get_config(aid).reduced()
    rspec = ref_configs.ShapeSpec(spec.name, seq_len=spec.seq_len,
                                  global_batch=spec.global_batch,
                                  kind=spec.kind)
    rwork = ref_frontend.extract_workload(rcfg, rspec)
    rnet = ref_network.optimize_network(list(rwork.layers),
                                        ref_default_arch(), "greedy",
                                        counts=list(rwork.counts),
                                        use_cache=False, workers=1)
    rarch = ref_default_arch()
    return (lower_plan(cfg, spec, net, default_arch()),
            ref_executor.lower_plan(rcfg, rspec, rnet, rarch))


@pytest.fixture(scope="module")
def glm_decode():
    return _plans("glm4-9b", DECODE)


def test_constants_kept_from_reference():
    assert NUMERICS_TOL == ref_executor.NUMERICS_TOL
    assert EXEC_BLOCK_CAP == ref_executor.EXEC_BLOCK_CAP
    assert DECODE_KV_CAP == ref_executor.DECODE_KV_CAP
    xs, ys = [1, 2, 2, 3, 5], [1, 3, 2, 4, 4]
    assert spearman(xs, ys) == ref_executor.spearman(xs, ys)


@pytest.mark.parametrize("aid,spec", CASES,
                         ids=[f"{a}-{s.kind}" for a, s in CASES])
def test_lower_plan_matches_reference(aid, spec):
    """Op names, kernels, counts, layer indices, segments and predicted
    cycles are the reference's; only block fields may differ, and they are
    in the CUDA kernels' tile sets."""
    plan, ref = _plans(aid, spec)
    assert (plan.model, plan.scenario, plan.arch_name, plan.n_segments) == \
        (ref.model, ref.scenario, ref.arch_name, ref.n_segments)
    assert plan.predicted_serial_cycles == ref.predicted_serial_cycles
    assert plan.predicted_scheduled_cycles == ref.predicted_scheduled_cycles
    assert len(plan.ops) == len(ref.ops)
    blocks = {"bm", "bk", "bn", "bq"}
    for a, b in zip(plan.ops, ref.ops):
        assert (a.name, a.kernel, a.count, a.layer_indices, a.segment,
                a.predicted_cycles) == (b.name, b.kernel, b.count,
                                        b.layer_indices, b.segment,
                                        b.predicted_cycles)
        assert {k: v for k, v in a.spec.items() if k not in blocks} == \
            {k: v for k, v in b.spec.items() if k not in blocks}
        assert set(a.spec) == set(b.spec)
    assert plan.n_unique <= ref.n_unique


def test_execute_plan_cpu_reduced_glm4_decode(glm_decode):
    """The slice on the CPU: every op runs its kernel's plain version,
    within tolerance of its oracle, with as many rank points as the
    reference's run of the same plan."""
    plan, ref = glm_decode
    rep = execute_plan(plan, device="cpu", seed=0)
    assert rep.numerics_ok
    assert {op.path for op in plan.ops} == {"plain"}
    assert {op.kernel for op in plan.ops} == {"matmul_int8",
                                              "flash_attention"}
    assert all(op.measured_s > 0 for op in plan.ops)
    assert rep.n_ops == len(plan.ops) and rep.n_unique == plan.n_unique
    rref = ref_executor.execute_plan(ref, interpret=True, seed=0)
    assert rref.numerics_ok
    assert len(rep.rank_points()) == len(rref.rank_points())
    assert rep.measured_total_s == pytest.approx(
        sum(op.count * op.measured_s for op in plan.ops))


def test_execute_plan_operands_deterministic(glm_decode):
    plan, _ = glm_decode
    memo_a, memo_b = {}, {}
    execute_plan(plan, device="cpu", seed=3, memo=memo_a, repeats=1)
    execute_plan(plan, device="cpu", seed=3, memo=memo_b, repeats=1)
    assert [memo_a[k][1] for k in memo_a] == [memo_b[k][1] for k in memo_a]


def test_default_device_without_cuda_raises(glm_decode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan, _ = glm_decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_plan(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_model(get_config("glm4-9b").reduced(), DECODE)


def test_ssd_ops_lower_but_do_not_run_yet():
    plan, _ = _plans("mamba2-1.3b", PREFILL)
    ssd = [op for op in plan.ops if op.kernel == "ssd_scan"]
    assert ssd
    with pytest.raises(NotImplementedError, match="B.3"):
        execute_plan(plan, device="cpu")


def test_serve_lm_cpu_reduced(tmp_path, monkeypatch, capsys):
    """The entry point end to end on the CPU at reduced widths."""
    from repro_torch import serve_lm
    monkeypatch.setenv("MIREDO_CACHE", str(tmp_path))
    rep = serve_lm.main(["--reduced", "--device", "cpu", "--mode",
                         "greedy"])
    out = capsys.readouterr().out
    assert rep.numerics_ok and rep.n_ops == 8 and rep.n_unique == 6
    assert {op.path for op in rep.plan.ops} == {"plain"}
    assert "[solve] glm4-9b decode_32k (greedy)" in out
    assert out.count("[exec]") == 6 and "[report] 8 ops" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--reduced", "--mode", "greedy"])
