"""The op-level analyzer (``repro_torch/roofline/op_analysis.py``) and the
roofline report against the contracts of ``tests/test_roofline.py`` and
the JAX package's ``analyze_compiled``.

- JAX's five analyzer contracts in the port's terms: a loop and its
  unrolled form count the same dot FLOPs (each trip is counted as it
  runs); ``2 m k n`` for a matmul; nested loops multiply; a contraction
  split 4-way over ``model`` (``dense_tp_reduce`` on an abstract mesh, on
  ``meta``) counts a quarter of the FLOPs a device and its f32 output's
  all-reduce; an elementwise chain counts FLOPs and no lower-bound bytes
  (eager torch does move them: ``bytes``).
- A reduced deepseek-7b forward in ``standard`` counts exactly JAX's
  ``analyze_compiled`` dot FLOPs of the same forward (no contraction
  differs).
- On ``meta`` under ``square_pallas`` the wrappers' launch records are
  what ``routing.select_matmul_route`` gives each contraction, in order,
  ``square_terms`` equals the audit's multiplies and ``dot_flops`` twice
  them; a wrapper on ``meta`` launches nothing and counts nothing.
- The report: the H100 datasheet peaks come from ``core/cost_model.py``,
  a square kernel's slots are priced on the CUDA cores (INT32 at half the
  FP32 rate), and ``fraction_of_floor`` reads a wall against the row.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.roofline.hlo_analysis import analyze_compiled  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import counting  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import meta, routing  # noqa: E402
from repro_torch.kernels.sq_matmul import sq_matmul_k1  # noqa: E402
from repro_torch.layers import basic  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_analysis import OpAnalyzer, analyze  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401


def test_loop_vs_unrolled_flops_match():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 16, 16)).astype(np.float32))
    x = torch.ones(4, 16)

    def looped(w, x):
        for wi in w:
            x = torch.tanh(x @ wi)
        return x

    def unrolled(w, x):
        x = torch.tanh(x @ w[0])
        x = torch.tanh(x @ w[1])
        x = torch.tanh(x @ w[2])
        x = torch.tanh(x @ w[3])
        x = torch.tanh(x @ w[4])
        x = torch.tanh(x @ w[5])
        x = torch.tanh(x @ w[6])
        return torch.tanh(x @ w[7])

    cs, cu = analyze(looped, w, x), analyze(unrolled, w, x)
    assert cs.dot_flops == cu.dot_flops == 8 * 2 * 4 * 16 * 16


def test_dot_flops_formula():
    c = analyze(torch.matmul, torch.ones(32, 64), torch.ones(64, 128))
    assert c.dot_flops == 2 * 32 * 64 * 128


def test_nested_loops_multiplied():
    w = torch.ones(3, 4, 8, 8)

    def f(w, x):
        for wo in w:
            for wi in wo:
                x = x @ wi
        return x

    assert analyze(f, w, torch.ones(2, 8)).dot_flops == 3 * 4 * (2 * 2 * 8 * 8)


def test_collective_bytes_counted():
    """JAX's 4-device contraction-sharded matmul, on an abstract 4-way
    ``model`` axis: a device contracts a quarter of K and all-reduces the
    (128, 64) f32 output."""
    mesh = shd.AbstractMesh((4,), ("model",))
    a = torch.empty(128, 256, device="meta")
    b = torch.empty(256, 64, device="meta")
    with dctx.use_mesh(mesh):
        c = analyze(basic.dense_tp_reduce, {"w": b}, a, mode="standard",
                    reduce_dtype=torch.float32)
    assert sum(c.collectives.values()) >= 128 * 64 * 4
    assert c.collectives == {"all-reduce": 128 * 64 * 4}
    assert c.dot_flops == 2 * 128 * 256 * 64 / 4


def test_elementwise_not_counted_as_lower_bound_bytes():
    c = analyze(lambda x: torch.tanh(x * 2 + 1), torch.ones(1024))
    assert c.elem_flops >= 1024
    assert c.bytes_lb <= 5 * 1024 * 4
    assert c.bytes == 3 * 2 * 1024 * 4        # eager: each op in and out


def test_reduced_deepseek_forward_dot_flops_match_jax():
    B, S = 2, 64
    jm = jbuild(jget("deepseek-7b").reduced())
    comp = jax.jit(lambda p, b: jm.forward(p, b)[0]).lower(
        jm.abstract_params(),
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile()
    want = analyze_compiled(comp).dot_flops
    model = build_model(get_config("deepseek-7b").reduced(), device="meta")
    params = model.abstract_params()
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    with torch.no_grad():
        got = analyze(lambda: model.forward(params, {"tokens": toks}))
    assert want > 0 and got.dot_flops == want
    assert got.launches == {} and got.square_terms == 0


def test_square_pallas_launches_follow_the_routes(monkeypatch):
    calls = []
    real = routing.select_matmul_route

    def spy(m, n, k, *, batch=1, dtype=torch.float32):
        route = real(m, n, k, batch=batch, dtype=dtype)
        calls.append((m, n, k, batch, route.name))
        return route

    spy.taken = real.taken            # the rule's own tally of its routes
    monkeypatch.setattr(routing, "select_matmul_route", spy)
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=2,
                              matmul_mode="square_pallas")
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    toks = torch.empty((1, 1024), dtype=torch.int32, device="meta")
    before = sq_matmul_k1.launches
    with torch.no_grad(), counting.track_contractions() as ctr, \
            meta.recording() as rec, OpAnalyzer() as an:
        model.forward(params, {"tokens": toks})
    assert sq_matmul_k1.launches == before       # nothing launched
    launched = [c for c in calls if c[4] != "virtual"]
    assert len(launched) == len(rec) == sum(an.cost.launches.values()) > 0
    for (m, n, k, b, route), r in zip(launched, rec):
        if r.kernel == "K1":
            assert (b, route, r.shape) == (1, "kernel", (m, k, n))
        elif r.kernel == "K2":
            assert route in ("batched", "kernel") and r.shape == (b, m, k, n)
        else:
            assert (r.kernel, route, r.shape) == ("K3", "fold", (b, m, k, n))
    c = an.cost
    assert c.square_terms == ctr.total_mults > 0
    assert c.dot_flops == 2 * c.square_terms == c.kernel_flops
    assert c.fp32_slots >= 2 * c.square_terms and c.int32_slots == 0


def test_meta_branch_of_each_kernel_launches_nothing():
    """K1-K8 on ``meta``: an empty output of the kernel's shape and dtype,
    one record each, nothing launched or counted on the kernels' own
    counters."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sq_paged_attn import sq_paged_attn

    def e(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    counters = {}
    with OpAnalyzer() as an:
        k1 = ops.sq_matmul(e(8, 16, dtype=torch.int8),
                           e(16, 4, dtype=torch.int8), device="meta")
        k2 = ops.sq_matmul(e(3, 8, 16), e(3, 16, 4), device="meta")
        k3 = ops.sq_matmul(e(3, 8, 16), e(3, 16, 4), fold=True,
                           device="meta")
        k4 = sq_paged_attn(e(2, 1, 2, 2, 8), e(32, 2, 8), e(32, 2, 8),
                           e(2, 4, dtype=torch.int32), e(32, dtype=torch.int32),
                           e(2, 1, dtype=torch.int32), block_size=8,
                           device="meta")
        k5, _ = ops.cpm3_matmul(e(4, 8, dtype=torch.complex64),
                                e(8, 2, dtype=torch.complex64), device="meta")
        k6, _ = ops.cpm4_matmul(e(4, 8, dtype=torch.complex64),
                                e(8, 2, dtype=torch.complex64), device="meta")
        k8 = ops.sq_conv(e(64), e(5), device="meta")
        k7 = ops.sq_conv2d(e(1, 3, 8, 8), e(4, 3, 3, 3), device="meta")
    for name, fn in (("K1", ops.sq_matmul_k1), ("K5", ops.cpm3_matmul_k5),
                     ("K7", ops.sq_conv2d_k7), ("K8", ops.sq_conv_k8)):
        counters[name] = fn.launches
    assert (k1.shape, k1.dtype) == ((8, 4), torch.int32)
    assert k2.shape == k3.shape == (3, 8, 4) and k4.shape == (2, 1, 2, 2, 8)
    assert k5.shape == k6.shape == (4, 2) and k8.shape == (60,)
    assert k7.shape == (1, 4, 6, 6)
    c = an.cost
    assert c.launches == {k: 1 for k in ("K1", "K2", "K3", "K4", "K5", "K6",
                                         "K7", "K8")}
    assert counters == {"K1": 0, "K5": 0, "K7": 0, "K8": 0}
    assert c.square_terms == (8 * 16 * 4 + 2 * 3 * 8 * 16 * 4
                              + 2 * 2 * 2 * 1 * 2 * 32 * 8
                              + (3 + 4) * 4 * 8 * 2 + 60 * 5 + 36 * 4 * 27)
    assert c.int32_slots > 0 and c.fp32_slots > 0


def test_report_prices_slots_against_datasheet_peaks():
    cell = {"arch": "a", "shape": "s", "kind": "prefill", "mesh": "1",
            "dot_flops_per_device": 2e12, "kernel_flops": 2e12,
            "elem_flops_per_device": 0.0, "bytes_per_device": 1e9,
            "bytes_lb_per_device": 1e9, "collective_bytes": {},
            "fp32_slots": 3.35e12, "int32_slots": 0.0,
            "n_active_params": 1e9, "tokens_per_device": 1000}
    row = report.roofline_row(cell)
    assert report.HW["bf16_tensor_flops"] == cm.BF16_TENSOR_FLOPS_PER_S \
        == 989.4e12
    assert report.HW["hbm_bw"] == 3.35e12 and report.HW["link_bw"] == 450e9
    assert row["compute_s"] == 0.0 and row["bottleneck"] == "slots"
    assert row["slot_s"] == pytest.approx(0.1)
    assert row["memory_s"] == pytest.approx(1e9 / 3.35e12)
    assert row["roofline_fraction_mfu"] == pytest.approx(
        2e12 / 989.4e12 / 0.1)
    ints = report.roofline_row(dict(cell, fp32_slots=0.0,
                                    int32_slots=3.35e12))
    assert ints["slot_s"] == pytest.approx(0.2)
    got = report.fraction_of_floor(row, 0.4)
    assert got["floor_share"] == pytest.approx(0.25)
    assert got["mfu"] == pytest.approx(2e12 / 989.4e12 / 0.4)
    text = report.format_table([row, {"arch": "b", "shape": "long_500k",
                                      "skipped": True, "reason": "why"}])
    assert "slots" in text and "skipped: why" in text
    by = report.format_by_arch([row, {"arch": "a", "shape": "long_500k",
                                      "skipped": True, "reason": "why"}])
    assert by.splitlines()[0] == "| arch | s | long_500k |"
    assert by.splitlines()[2] == "| a | 0.1 s s, MFU 2.02% | skipped |"


def test_report_prices_elementwise_at_one_slot_an_element():
    """The analyzer counts one elementwise or reduction FLOP an output
    element, and such an op (no FMA) takes one FP32 issue slot an element:
    ``elem_s`` is at the slot rate, in one pool with the square kernels'
    slots."""
    cell = {"arch": "a", "shape": "s", "kind": "prefill", "mesh": "1",
            "dot_flops_per_device": 2e12, "kernel_flops": 2e12,
            "elem_flops_per_device": 3.35e12, "bytes_per_device": 1e9,
            "bytes_lb_per_device": 1e9, "collective_bytes": {},
            "fp32_slots": 3.35e12, "int32_slots": 0.0,
            "n_active_params": 1e9, "tokens_per_device": 1000}
    row = report.roofline_row(cell)
    assert report.HW["fp32_slots"] == cm.FP32_SLOTS_PER_S == 33.5e12
    assert row["elem_s"] == pytest.approx(0.1) == row["slot_s"]
    assert row["bottleneck"] == "slots"
    assert row["floor_s"] == pytest.approx(0.2)
