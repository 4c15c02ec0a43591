"""The yardstick's arithmetic against counts worked out by hand: the
operations and bytes of each kernel, the roofline and mfu shares, the
device's busy time and idle gaps, and the percentile."""

import pytest

from bench import harness, peaks
from bench.trace import Trace


def _read(name, e2e, trace, work, spans=None):
    mod = harness.load_module("metrics", name)
    return mod.read(harness.Context(e2e, trace, work, spans or {}))


def test_matmul_int8_counts():
    # glm4-9b's wq at decode: 128 x 4096 @ 4096 x 4096
    ops, nbytes = peaks.matmul_int8(128, 4096, 4096)
    assert ops == 2 * 128 * 4096 * 4096 == 4_294_967_296
    # x 524,288 + w 16,777,216 + scales 4 * 4,224 + out 4 * 524,288
    assert nbytes == 524_288 + 16_777_216 + 16_896 + 2_097_152
    assert peaks.bound_s(ops, nbytes, "int8") == nbytes / 3.35e12


def test_flash_counts():
    ops, nbytes = peaks.flash_decode(128, 1, 512, 32, 128)
    assert ops == 4 * 128 * 32 * 512 * 128
    assert nbytes == 4 * 128 * 32 * 128 * (2 + 1024)
    ops, nbytes = peaks.flash_prefill(1, 4, 2, 8)
    # 4 + 3 + 2 + 1 = 10 causal pairs, 2 heads, 2 products of 2 hd each
    assert ops == 4 * 2 * 8 * 10
    assert nbytes == 4 * 2 * 8 * 16


def test_dense_forward_ops():
    c = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "gated_mlp": True, "n_layers": 3, "padded_vocab": 32}
    # per layer: q 8*8, k and v 2*8*4, o 8*8, mlp 3*8*16
    assert peaks.dense_matmul_params(c) == 3 * (64 + 64 + 64 + 384)
    got = peaks.dense_forward_ops(c, batch=2, seq=4, head_rows=2)
    attn = 3 * 4 * 2 * 2 * 4 * 10
    assert got == 2 * 1728 * 8 + attn + 2 * 8 * 32 * 2


def test_trace_busy_idle_and_gaps():
    tr = Trace(2.0, [("a", 0.0, 0.5), ("b", 0.25, 0.75),
                     ("Memcpy DtoD (Device -> Device)", 1.0, 1.5)],
               [("host.step", 0.0, 2.0), ("aten::mm", 0.7, 1.2)], 1)
    assert tr.busy_s() == pytest.approx(1.25)
    assert tr.idle_share() == pytest.approx(0.375)
    assert tr.device_s(lambda n: n == "a") == 0.5
    # the gap at 0.75 began inside aten::mm, the one at 1.5 inside the step
    # (the innermost call under way)
    assert tr.idle_gaps() == [["host.step", 0.5], ["aten::mm", 0.25]]
    assert tr.top_ops()[0] == ["b", 0.5] or tr.top_ops()[0][1] == 0.5


def test_metric_readers_by_hand():
    shapes = [(128, 4096, 4096)] * 2
    bound = peaks.matmul_int8(*shapes[0])[1] / 3.35e12
    t = 4 * bound
    tr = Trace(1.0, [("void matmul_int8_kernel<128, 128, 128>", 0.0, t),
                     ("elementwise_kernel", t, 0.5)], [], 2)
    work = {"steps": 2, "matmul_int8": shapes, "flash": []}
    # two steps of two instances: 4 bounds in 4 bounds of kernel time
    assert _read("matmul_int8_roofline.exec", "exec_step_ms", tr,
                 work) == pytest.approx(100.0)
    assert _read("quantize_share.exec", "exec_step_ms", tr, work) == \
        pytest.approx(100 * (0.5 - t) / 0.5)
    assert _read("idle_share.exec", "exec_step_ms", tr, work) == \
        pytest.approx(50.0)
    ops = 2 * 2 * 2.0 * 128 * 4096 * 4096     # 2 steps of 2 instances
    assert _read("mfu.exec", "exec_step_ms", tr, work) == \
        pytest.approx(100 * ops / 1.979e15)
    assert _read("matmul_int8_roofline.exec", "itl_ms_p95", tr, work) is None
    tr2 = Trace(2.0, [("k", 0.0, 1.0), ("Memcpy DtoD (Device -> Device)",
                                        1.0, 1.5)], [], 2)
    assert _read("copy_share.train", "train_tokens_per_s", tr2, {}) == \
        pytest.approx(100 / 3)
    assert _read("mfu.train", "train_tokens_per_s", tr2,
                 {"steps": 2, "train_ops": 989e12, "precision": "bf16"}) == \
        pytest.approx(100.0)
    assert _read("launches_per_step.decode", "itl_ms_p95", tr2,
                 {"steps": 2}) == 0.5
    tr3 = Trace(1.0, [("sm90_xmma_gemm_f32f32", 0.0, 0.6),
                      ("flash_prefill_kernel<32,64>", 0.6, 0.8)], [], 1)
    assert _read("gemm_share.prefill", "ttft_ms_p95", tr3, {}) == \
        pytest.approx(75.0)
    need = peaks.flash_prefill(4, 4096, 36, 64)[0] / 495e12
    assert _read("flash_prefill_roofline.prefill", "ttft_ms_p95", tr3,
                 {"flash_prefill": [(4, 4096, 36, 64)]}) == \
        pytest.approx(100 * need / 0.2)
    assert _read("solve_s.exec", "exec_step_ms", None, {},
                 {"solve_s": 5.5}) == 5.5


def test_flash_readers_by_hand():
    dec, pre = (128, 1, 512, 32, 128, False), (1, 64, 64, 2, 16, True)
    work = {"steps": 3, "matmul_int8": [], "flash": [dec, pre]}
    t = peaks.flash_decode(*dec[:5])[1] / 3.35e12
    tr = Trace(1.0, [("void flash_decode_kernel<4, float>", 0.0, 3 * t)],
               [], 3)
    # only the decode (non-causal) instance counts toward its roofline
    assert _read("flash_decode_roofline.exec", "exec_step_ms", tr,
                 work) == pytest.approx(100.0)
    ops = 4 * 128 * 32 * 512 * 128 + 4 * 2 * 16 * 64 * 65 / 2
    assert _read("mfu.exec", "exec_step_ms", tr, work) == \
        pytest.approx(100 * 3 * ops / 1.979e15)


def test_percentile():
    assert harness.percentile([3, 1, 2, 4, 5], 0.5) == 3
    assert harness.percentile(range(101), 0.95) == 95
    assert harness.percentile([10, 20], 0.95) == pytest.approx(19.5)
    assert harness.worst([1.0, float("nan")]) == float("inf")
