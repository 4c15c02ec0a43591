"""The mesh step on each rank's own shards, at published widths: the LM
head (`sharding.rules.unembed_on_shards`), the loss
(`rules.loss_on_shards`), the MoE's dispatch and combine
(`rules.moe_dispatch_on_shards`) and the microbatches
(`rules.local_microbatches`) leave no rank holding the global batch's
logits, the whole vocab against its rows, or the global token count's
rows of a MoE layer.

Each case runs one step of a dry-run cell (``train_4k``, ``prefill_32k``)
on the dry run's 16 x 16 mesh over the fake process group, in a
subprocess (the group is process-wide), with the model, its state and the
batch as meta ``DTensor``s laid by the plan, so the published widths cost
nothing; one layer unit of each arch. A dispatch mode below DTensor sees
every local op's results (`Seen`), as the dry run's memory count does.
DTensor lays an op by its shapes and the mesh: on a (2, 2) mesh at small
shapes the head's faults did not show.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

#: (arch, cell): the untied head (glm4-9b), the tied head of an ssm
#: (mamba2-1.3b), a vlm whose logits follow an image prefix (pixtral-12b).
HEAD_CELLS = [(arch, shape) for arch in ("glm4-9b", "mamba2-1.3b",
                                         "pixtral-12b")
              for shape in ("train_4k", "prefill_32k")]
#: The MoE archs: experts whole (qwen2-moe-a2.7b's 60 on 16) and expert
#: parallel (arctic-480b's 128).
MOE_CELLS = [(arch, shape) for arch in ("qwen2-moe-a2.7b", "arctic-480b")
             for shape in ("train_4k", "prefill_32k")]

_CELLS = """
import dataclasses, json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch.dryrun import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, transformer
from repro_torch.sharding import rules
from repro_torch.sharding.state import map_state, place, place_batch
from repro_torch.train import optimizer, steps

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(multi_pod=False, device_type="cpu")
torch.set_num_threads(1)


class Seen(TorchDispatchMode):
    '''The local (plain) results of every op dispatched under it: the
    largest floating one with a dimension in ``vocab``, and those whose
    first dimension is in ``rows``.'''

    def __init__(self, vocab, rows):
        super().__init__()
        self.vocab, self.rows = set(vocab), set(rows)
        self.largest, self.hits = (0, None, None), []

    def __torch_dispatch__(self, func, types, args=(), kw=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kw or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if type(t) is not torch.Tensor:
                continue
            if t.is_floating_point() and self.vocab & set(t.shape) and \
                    t.numel() > self.largest[0]:
                self.largest = (t.numel(), list(t.shape), str(func))
            if t.ndim and t.shape[0] in self.rows and len(self.hits) < 5:
                self.hits.append((list(t.shape), str(func)))
        return out


def named(pl):
    return [f"S{p.dim}" if isinstance(p, Shard) else type(p).__name__
            for p in pl]


class Recording(rules.PlanShard):
    hidden = None

    def __call__(self, name, x):
        if name == "hidden" and self.hidden is None:
            self.hidden = named(x.placements)
        return super().__call__(name, x)


def run(arch, shape, microbatches=1, use_flash=False):
    full = get_config(arch)
    unit = full.attn_every if full.family == "hybrid" else 1
    cfg = dataclasses.replace(full, n_layers=unit, **(
        {"encoder_layers": 1} if full.family == "encdec" else {}))
    shape = SHAPES[shape]
    plan = rules.make_plan(mesh, cfg, shape)
    step_cfg = steps.StepConfig(microbatches=microbatches,
                                use_flash=use_flash)
    model = map_state(
        transformer.init_model(cfg, None, torch.float32, "meta"),
        lambda n, p: place(p, mesh, plan.param_spec_for(n, p)))
    data = {k: place_batch(v, plan, microbatches)
            for k, v in input_specs(cfg, shape).items()}
    shard = Recording(plan)
    tokens = shape.global_batch * shape.seq_len
    vocab = cfg.padded_vocab()
    seen = Seen({vocab, vocab // 16}, {tokens, tokens * cfg.top_k}
                if cfg.n_experts else ())
    flash_args, flash = [], attention._flash

    def recording(q, k, v):
        # the kernel has no meta version: its output's shape will do
        flash_args.extend(type(t).__name__ for t in (q, k, v))
        return torch.empty_like(q)

    attention._flash = recording
    with seen:
        if shape.kind == "train":
            params = dict(model.named_parameters())
            state = steps.TrainState(model, optimizer.init_adamw(params),
                                     None, 0)
            steps.make_train_step(cfg, optimizer.OptimizerConfig(),
                                  step_cfg, shard)(state, data)
        else:
            steps.make_prefill_step(cfg, step_cfg, shard)(model, data)
    attention._flash = flash
    logits = [shape.global_batch // 16, shape.seq_len, vocab // 16]
    return {"largest": seen.largest, "logits": logits, "hits": seen.hits,
            "hidden": shard.hidden, "flash_args": sorted(set(flash_args))}


out = {}
for arch, shape, mb, flash in json.loads(sys.argv[1]):
    out[f"{arch}/{shape}/{mb}" + ("/flash" if flash else "")] = run(
        arch, shape, mb, flash)
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    """Every case's record, from one subprocess."""
    todo = [(arch, shape, 1, False)
            for arch, shape in HEAD_CELLS + MOE_CELLS]
    todo += [("glm4-9b", "train_4k", 2, False),
             ("glm4-9b", "prefill_32k", 1, True)]
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_CELLS),
                          json.dumps(todo)], env=ENV, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", HEAD_CELLS)
def test_no_rank_holds_more_than_its_logits(cells, arch, shape):
    """No local float tensor of the step with a dimension of the vocab (V
    or its slice V/16) is larger than twice the logits' local shard
    (B/16, L, V/16): the head multiplies each rank's rows by its own vocab
    slice, and the loss's backward leaves each rank its own shard of the
    float32 gradient. Where DTensor chose the head's layout, it multiplied
    the global batch by the whole vocab, and the loss's backward gathered
    the gradient over ``data`` or ``model``."""
    got = cells[f"{arch}/{shape}/1"]
    numel, shape, op = got["largest"]
    logits = got["logits"]
    assert numel <= 2 * logits[0] * logits[1] * logits[2], (shape, op,
                                                            logits)


@pytest.mark.parametrize("arch,shape", MOE_CELLS)
def test_moe_holds_only_its_own_tokens(cells, arch, shape):
    """No local tensor of a MoE step has rows by the global token count
    T or T * top_k ((T, D), (T * K, D), (T, K, D), the router's (T, E)):
    each rank routes, dispatches and combines its own tokens, and only
    the (E,) counts of routed slots are gathered."""
    got = cells[f"{arch}/{shape}/1"]
    assert got["hits"] == [], got["hits"]


def test_microbatches_keep_each_ranks_rows(cells):
    """With two microbatches the forward's hidden state stays split over
    ``data`` (each rank's local chunk is its share of a microbatch); the
    chunks of a DTensor split along its rows were gathered onto every
    rank."""
    assert cells["glm4-9b/train_4k/2"]["hidden"] == ["S0", "Replicate"]


def test_flash_prefill_runs_on_each_ranks_shards(cells):
    """A prefill with ``use_flash`` hands the flash_attention kernel's
    wrapper each rank's local tensors (through ``shard.attend``), where
    it was handed the ``DTensor``s themselves, whose storage is no
    rank's."""
    assert cells["glm4-9b/prefill_32k/1/flash"]["flash_args"] == ["Tensor"]
