"""The port's two harnesses against the reference's: the bridge bench
(`repro_torch.gpu_bridge_bench`) against ``benchmarks/tpu_bridge_bench.py``
and the hill-climb (`repro_torch.perf_hillclimb`) against
``benchmarks/perf_hillclimb.py``; the dry run's memory counter
(`launch.dryrun.StepMemory`) on a chain of meta ops whose counts are known
exactly; variants of reduced dry-run cells on the fake process group, each
in its own process; and the mesh faults the counter brought to light (the
split into heads over a model axis that does not divide them, a
one-microbatch batch gathered onto every rank, the label mask made
vocab-wide).

The reference's hill-climb is read with ``ast``, not imported: importing
it asks XLA for 512 host devices for the whole worker."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")
import torch

from benchmarks import tpu_bridge_bench
from repro.configs import get_config as rget_config
from repro_torch import gpu_bridge_bench, perf_hillclimb
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import gpu_bridge
from repro_torch.kernels.matmul_int8 import kernel as mm_kernel
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
REF_HILLCLIMB = ROOT / "benchmarks" / "perf_hillclimb.py"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(code: str, *args, timeout=600) -> dict:
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)], env=ENV, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _reference_hillclimb() -> ast.Module:
    return ast.parse(REF_HILLCLIMB.read_text())


def _reference_variants() -> dict[str, str]:
    """The reference's variant keys and hypotheses, from its source."""
    for node in ast.walk(_reference_hillclimb()):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "VARIANTS":
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                hyp = next(kw.value for kw in v.keywords
                           if kw.arg == "hypothesis")
                out[k.value] = ast.literal_eval(hyp)
            return out
    raise AssertionError("no VARIANTS in the reference")


def _reference_record_keys() -> tuple[set, set]:
    """The keys of the reference's record (``result``) and of its
    ``after_raw``."""
    for node in ast.walk(_reference_hillclimb()):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "result":
            keys = {k.value for k in node.value.keys}
            raw = node.value.values[[k.value for k in node.value.keys]
                                    .index("after_raw")]
            return keys, set(ast.literal_eval(raw.generators[0].iter))
    raise AssertionError("no result record in the reference")


# ---- the bridge bench ------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_dominant_gemm_equals_reference(arch_id):
    assert gpu_bridge_bench.dominant_gemm(get_config(arch_id)) == \
        tpu_bridge_bench.dominant_gemm(rget_config(arch_id))


def test_bench_rows_optimal_fit_and_least_model_time(tmp_path):
    """Every row's pick is OPTIMAL, of the kernel's tile set, its whole
    ring within one CTA's opt-in shared memory, and its estimate no more
    than the model's time at any tile (within the solver's 1e-6
    relative); the JSON record and the flash pick beside them."""
    payload = gpu_bridge_bench.run(str(tmp_path))
    rows = payload["rows"]
    assert [r["arch"] for r in rows] == list(ARCH_IDS)
    tiles = [(bm, bk, bn) for bm in mm_kernel.BM_TILES
             for bk in mm_kernel.BK_TILES for bn in mm_kernel.BN_TILES]
    for r in rows:
        m, k, n = r["gemm"]
        assert r["status"] == "OPTIMAL", r
        assert tuple(r["pick"]) in tiles
        assert r["smem_bytes"] == mm_kernel.smem_bytes(*r["pick"])
        assert r["fits"] and r["smem_bytes"] <= gpu_bridge.SMEM_BYTES
        best = min(gpu_bridge.matmul_seconds(m, k, n, bm, bn)
                   for bm, _, bn in tiles) * 1e3
        assert r["est_ms"] <= best * (1 + 1e-6), r
        assert r["largest_ms"] == gpu_bridge.matmul_seconds(
            m, k, n, 128, 128) * 1e3
    assert json.loads((tmp_path / "gpu_bridge.json").read_text()) == \
        json.loads(json.dumps(payload))
    bq, bk = payload["flash_blocks_32k"]
    assert (bq, bk) == gpu_bridge_bench.flash_pick()
    assert payload["flash_cell"]["batch_heads"] == 32 * 32


# ---- the hill-climb's variants ---------------------------------------------

def test_variants_match_reference():
    """The reference's eight keys and hypotheses; combo-opt16's restated
    against the H100's memory."""
    ref = _reference_variants()
    assert list(perf_hillclimb.VARIANTS) == list(ref)
    for key, hyp in ref.items():
        got = perf_hillclimb.VARIANTS[key]["hypothesis"]
        if key == "combo-opt16":
            assert "80 GB" in got and "v5e" not in got
        else:
            assert got == hyp, key


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_pad_heads_to_the_model_axis(arch_id):
    cfg = get_config(arch_id)
    padded = perf_hillclimb._pad_heads(cfg)
    assert padded.n_heads % 16 == 0
    assert cfg.n_heads <= padded.n_heads < cfg.n_heads + 16
    assert padded.n_kv_heads == (padded.n_heads if cfg.n_kv_heads ==
                                 cfg.n_heads else cfg.n_kv_heads)


def test_flags_restored_after_a_lowering_that_raises(tmp_path, monkeypatch):
    """Every flag a variant sets is back at its value when the lowering
    raises; the record says what failed."""
    from repro_torch.models import attention, moe
    from repro_torch.train import optimizer
    seen = []

    def boom(*args, **kw):
        seen.append((moe.MOE_DISPATCH, attention.ATTN_IMPL,
                     optimizer.OPT_STATE_DTYPE))
        raise RuntimeError("lowering failed")

    monkeypatch.setattr(moe, "MOE_DISPATCH", "einsum")
    monkeypatch.setattr(attention, "ATTN_IMPL", "naive")
    before = (moe.MOE_DISPATCH, attention.ATTN_IMPL,
              optimizer.OPT_STATE_DTYPE)
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    r = perf_hillclimb.run_variant("arctic-480b:train_4k:single",
                                   "combo-opt16", str(tmp_path),
                                   mesh=object())
    assert seen[0] == ("scatter", "chunked", torch.bfloat16)
    assert (moe.MOE_DISPATCH, attention.ATTN_IMPL,
            optimizer.OPT_STATE_DTYPE) == before
    assert r["after"] is None and r["after_raw"]["status"] == "error"
    assert "lowering failed" in r["after_raw"]["error"]


# ---- the memory counter ----------------------------------------------------

def test_step_memory_of_a_chain_of_meta_ops():
    """Peak live bytes and bytes accessed of a short chain, known exactly:
    held arguments count from the start, views move no bytes and share
    their storage, a freed result leaves the live count, and a tensor
    autograd saved stays live after its name is gone."""
    x = torch.empty(1000, device="meta")                 # 4,000 bytes
    with dryrun.StepMemory() as m:
        assert m.hold({"x": x}) == 4000
        y = x * 2                     # read 4,000, write 4,000; live 8,000
        z = y + 1                     # 8,000 more; live 12,000: the peak
        del y                         # live 8,000
        w = z.view(10, 100)           # a view: nothing moved or made
        s = w.sum()                   # read 4,000, write 4; live 8,004
        h = z.to(torch.float16)       # read 4,000, write 2,000; 10,004
        live = m.live
    assert (m.peak, live) == (12_000, 10_004)
    assert m.accessed == 8000 + 8000 + 4004 + 6000
    del s, h, w, z
    a = torch.empty(1000, device="meta", requires_grad=True)
    with dryrun.StepMemory() as m:
        m.hold(a)
        b = a.exp()                   # saved for the backward: stays live
        c = b.sum()
        del b
        assert m.live == 4000 + 4000 + 4
    del c


# ---- reduced cells on the fake process group -------------------------------

#: Lowers a reduced cell under a variant with `perf_hillclimb.run_variant`
#: on the fake single-pod mesh; argv: arch, shape, variant, out dir,
#: baseline dir ("" for none), and the baseline's MoE dispatch ("" to
#: lower none into it). Prints the result.
_VARIANT = """
    import json, os, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import perf_hillclimb
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe

    arch, shape, variant, out, base, dispatch = sys.argv[1:7]
    cfg = get_config(arch).reduced()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        if dispatch:
            old, moe.MOE_DISPATCH = moe.MOE_DISPATCH, dispatch
            rec = lower_cell(arch, shape, multi_pod=False, mesh=mesh,
                             cfg=cfg)
            moe.MOE_DISPATCH = old
            os.makedirs(base, exist_ok=True)
            with open(os.path.join(base, f"{arch}__{shape}__single.json"),
                      "w") as f:
                json.dump(rec, f)
        r = perf_hillclimb.run_variant(f"{arch}:{shape}:single", variant,
                                       out, base or None, mesh=mesh,
                                       cfg=cfg)
    finally:
        dist.destroy_process_group()
    r["files"] = sorted(os.listdir(out))
    print(json.dumps(r))
"""


def _variant(tmp_path, arch, shape, variant, dispatch=""):
    base = str(tmp_path / "base") if dispatch else ""
    return _run(_VARIANT, arch, shape, variant, tmp_path / "out", base,
                dispatch)


def _mem(raw):
    return raw["memory"]


def test_kv_int8_halves_the_decode_cache_and_keeps_the_record(tmp_path):
    """kv-int8 on a reduced glm4-9b ``decode_32k``: the int8 K and V are
    half the bfloat16 ones, their scales laid as the cache (its sequence
    split over ``model``), and the rest of the cache (its lengths) as it
    was.
    The record has the reference's keys and file name, the memory counts
    non-null."""
    r = _variant(tmp_path, "glm4-9b", "decode_32k", "kv-int8")
    keys, raw = _reference_record_keys()
    assert keys <= set(r) and raw <= set(r["after_raw"])
    assert r["files"] == ["glm4-9b__decode_32k__single__kv-int8.json"]
    assert r["baseline"] == "lowered at the module defaults"
    after, before = r["after_raw"], r["before_raw"]
    assert after["status"] == before["status"] == "ok"
    for raw_ in (after, before):
        mem = _mem(raw_)
        assert raw_["bytes_accessed_per_device"] > 0
        assert mem["peak_bytes"] > mem["argument_bytes"] > 0
        assert mem["temp_bytes_per_device"] > 0
        assert mem["temp_bytes"] == mem["temp_bytes_per_device"] * 256
    got = _run("""
        import json, sys
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import attention
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        cfg = get_config("glm4-9b").reduced()
        out = {}
        for quant in (False, True):
            attention.KV_QUANT = quant
            out[quant] = lower_cell("glm4-9b", "decode_32k", multi_pod=False,
                                    mesh=mesh, cfg=cfg)["shapes"]["caches"]
        dist.destroy_process_group()
        print(json.dumps(out))
        """)
    plain, quant = got["false"], got["true"]
    kv = lambda c: sum(c[n]["bytes_per_device"] for n in ("k", "v"))
    scales = sum(quant[n]["bytes_per_device"] for n in ("k_scale", "v_scale"))
    assert kv(quant) * 2 == kv(plain)
    assert quant["k_scale"]["spec"] == quant["k"]["spec"] == plain["k"]["spec"]
    total = lambda c: sum(e["bytes_per_device"] for e in c.values())
    assert total(quant) - kv(quant) - scales == total(plain) - kv(plain)
    hd = get_config("glm4-9b").reduced().resolved_head_dim
    assert scales * hd == kv(quant) * 4


def test_no_remat_trades_flops_for_temporaries(tmp_path):
    r = _variant(tmp_path, "minicpm-2b", "train_4k", "no-remat")
    after, before = r["after_raw"], r["before_raw"]
    assert after["flops_per_device"] < before["flops_per_device"]
    assert _mem(after)["temp_bytes_per_device"] > \
        _mem(before)["temp_bytes_per_device"]
    assert after["bytes_per_device"] == before["bytes_per_device"]


def test_moe_scatter_against_an_einsum_baseline(tmp_path):
    """moe-scatter on a reduced qwen2-moe-a2.7b ``train_4k`` against a
    baseline lowered with the one-hot einsum dispatch and read from the
    baseline directory: fewer bytes accessed and temporaries."""
    r = _variant(tmp_path, "qwen2-moe-a2.7b", "train_4k", "moe-scatter",
                 dispatch="einsum")
    assert r["baseline"].endswith("qwen2-moe-a2.7b__train_4k__single.json")
    after, before = r["after_raw"], r["before_raw"]
    assert after["bytes_accessed_per_device"] < \
        before["bytes_accessed_per_device"]
    assert _mem(after)["temp_bytes_per_device"] < \
        _mem(before)["temp_bytes_per_device"]


def test_a_named_baseline_that_is_missing_raises(tmp_path):
    """A baseline directory without the cell's record is an error, raised
    before anything is lowered or written, never a diff against the cell
    lowered at the defaults."""
    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError, match="glm4-9b__decode_32k__"
                       "single.json"):
        perf_hillclimb.run_variant("glm4-9b:decode_32k:single", "kv-int8",
                                   str(out), str(tmp_path / "base"))
    assert not out.exists()


def test_pad_heads_lowers_a_padded_cell(tmp_path):
    r = _variant(tmp_path, "minicpm-2b", "decode_32k", "pad-heads")
    assert r["after_raw"]["status"] == "ok"
    assert r["after"]["t_compute_s"] >= r["before"]["t_compute_s"]


# ---- faults of the mesh path that the memory count showed -------------------

def test_mesh_train_step_keeps_batch_and_vocab_split():
    """On a fake (data 2, model 2) mesh, a reduced minicpm-2b train step
    with one microbatch: the batch reaches the forward still split over
    ``data`` (``chunk`` on a DTensor split along its rows gathers them
    onto every rank), no boolean tensor of the step is larger than the
    logits' shard (the label mask is made on each rank's vocab slice), and
    a projection whose columns the product split over an axis that does
    not divide its heads is split into heads (`PlanShard.heads`) where a
    plain reshape raises."""
    got = _run("""
        import json
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.launch.dryrun import input_specs, sanitize
        from repro_torch.models import transformer
        from repro_torch.sharding import rules
        from repro_torch.sharding.state import map_state, place
        from repro_torch.train import steps

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("minicpm-2b").reduced()
        shape = ShapeSpec("t", 64, 8, "train")
        plan = rules.make_plan(mesh, cfg, shape)

        class Largest(TorchDispatchMode):
            most = 0
            def __torch_dispatch__(self, func, types, args=(), kw=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kw or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and \\
                            type(t) is torch.Tensor and \\
                            t.dtype == torch.bool:
                        self.most = max(self.most, t.numel())
                return out

        def named(placements):
            return [f"S{p.dim}" if isinstance(p, Shard) else
                    type(p).__name__ for p in placements]

        class Recording(rules.PlanShard):
            hidden = None
            def __call__(self, name, x):
                if name == "hidden" and self.hidden is None:
                    self.hidden = named(x.placements)
                return super().__call__(name, x)

        model = map_state(
            transformer.init_model(cfg, None, torch.float32, "meta"),
            lambda n, p: place(p, mesh, plan.param_spec_for(n, p)))
        batch = {k: place(v, mesh, sanitize(plan.batch_spec(), v.shape,
                                            mesh))
                 for k, v in input_specs(cfg, shape).items()}
        shard = Recording(plan)
        with Largest() as mode:
            steps.loss_and_grads(model, cfg, steps.StepConfig(), batch,
                                 shard)
        logits = 8 // 2 * 64 * cfg.padded_vocab() // 2
        heads = 3
        x = distribute_tensor(torch.empty(4, 8, heads * 16, device="meta"),
                              mesh, [Replicate(), Shard(2)])
        try:
            x.reshape(4, 8, heads, 16)
            plain = "split"
        except RuntimeError:
            plain = "raised"
        y = shard.heads(x, heads, 16)
        print(json.dumps({"hidden": shard.hidden, "most": mode.most,
                          "logits": logits, "plain": plain,
                          "heads": list(y.shape),
                          "heads_placements": named(y.placements)}))
        dist.destroy_process_group()
        """)
    assert got["hidden"] == ["S0", "Replicate"]
    assert got["most"] <= got["logits"], got
    assert got["plain"] == "raised"
    assert got["heads"] == [4, 8, 3, 16]
    assert got["heads_placements"] == ["Replicate", "Replicate"]


def test_gradient_handed_back_copies_only_what_it_must():
    """`PlanShard.keep`'s backward returns a gradient already on the
    value's layout with a contiguous shard as it is, and copies one whose
    shard is transposed into contiguous memory (values kept)."""
    got = _run("""
        import json, types
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.sharding import rules

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        ctx = types.SimpleNamespace(layout=(mesh, (Shard(0),)))
        local = torch.arange(12.0).reshape(3, 4)
        flat = DTensor.from_local(local, mesh, [Shard(0)])
        strided = DTensor.from_local(local.t().contiguous().t(), mesh,
                                     [Shard(0)])
        same = rules._GradBack.backward(ctx, flat)
        copied = rules._GradBack.backward(ctx, strided)
        print(json.dumps({
            "same": same is flat,
            "was": strided.to_local().is_contiguous(),
            "now": copied.to_local().is_contiguous(),
            "equal": torch.equal(copied.to_local(), local)}))
        dist.destroy_process_group()
        """)
    assert got == {"same": True, "was": False, "now": True, "equal": True}


#: Dry-run cells that failed on the fake mesh before the repairs, at the
#: reduced widths with the overrides given (None: the published config):
#: the MoE's shared experts left their rows split 256 ways, which a batch
#: of 32 cannot take back (qwen2-moe-a2.7b ``prefill_32k``), nor their
#: gradient one of 128 (``train_8k``, only at published widths); a
#: decode's length-1 sequence laid on the ``data`` axis (mamba2-1.3b
#: ``long_500k``); with the batch kept split, a projection's gradient
#: reached the product's backward with a transposed shard (an
#: encoder-decoder whose 16 heads split over ``model``).
FAULT_CELLS = (("qwen2-moe-a2.7b", "prefill_32k", {}),
               ("qwen2-moe-a2.7b", "train_8k", None),
               ("mamba2-1.3b", "long_500k", {}),
               ("seamless-m4t-large-v2", "train_4k",
                {"n_heads": 16, "n_kv_heads": 16}))


@pytest.fixture(scope="module")
def fault_cells():
    return _run("""
        import dataclasses, json, sys
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.mesh import make_production_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        out = {}
        for arch, shape, over in json.loads(sys.argv[1]):
            cfg = get_config(arch) if over is None else \\
                dataclasses.replace(get_config(arch).reduced(), **over)
            rec = lower_cell(arch, shape, multi_pod=False, mesh=mesh,
                             cfg=cfg)
            out[f"{arch}/{shape}"] = {
                k: rec.get(k) for k in ("status", "collective_reason",
                                        "bytes_accessed_per_device")}
            out[f"{arch}/{shape}"]["peak"] = rec["memory"]["peak_bytes"]
        dist.destroy_process_group()
        print(json.dumps(out))
        """, json.dumps(FAULT_CELLS))


@pytest.mark.parametrize("arch,shape,over", FAULT_CELLS)
def test_mesh_faults_repaired_on_dry_run_cells(fault_cells, arch, shape,
                                               over):
    got = fault_cells[f"{arch}/{shape}"]
    assert got["status"] == "ok" and got["collective_reason"] is None, got
    assert got["bytes_accessed_per_device"] > 0 and got["peak"] > 0
