"""The port's cost model (``repro_torch/core/cost_model.py``) against the JAX
package's (``repro/core/cost_model.py``).

- The paper's gate-area model, function by function, equal to JAX's on a
  grid of bit widths and reduction depths (plain arithmetic: exactly).
- The byte terms and the PM lane-op count the route rules read, equal to
  JAX's; the route planner reads them from here.
- The H100 launch model: blocks in waves over 132 SMs, the blocks an SM
  holds by threads and shared memory, FP32 issue slots and bytes.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro.core import cost_model as jcm  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402

BITS = (2, 4, 8, 12, 16, 24, 32)
DEPTHS = (1, 2, 3, 64, 1000, 1024, 4096, 65536)


@pytest.mark.parametrize("fn", ["mac_cost", "pm_mac_cost",
                                "complex_mac_cost", "cpm4_cost", "cpm3_cost"])
def test_unit_costs_equal_jax(fn):
    for n, depth in itertools.product(BITS, DEPTHS):
        got, want = getattr(tcm, fn)(n, depth), getattr(jcm, fn)(n, depth)
        assert (got.name, got.area, got.squarers, got.multipliers,
                got.adders) == (want.name, want.area, want.squarers,
                                want.multipliers, want.adders), (fn, n, depth)


@pytest.mark.parametrize("square", [False, True])
def test_array_costs_equal_jax(square):
    for n, depth, (r, c) in itertools.product(
            (4, 8, 16, 32), (16, 1024), ((1, 1), (8, 8), (128, 128),
                                         (3, 17))):
        got = tcm.systolic_array_cost(r, c, n, square, depth)
        want = jcm.systolic_array_cost(r, c, n, square, depth)
        assert (got.name, got.area, got.squarers, got.multipliers) == \
            (want.name, want.area, want.squarers, want.multipliers)
        got = tcm.tensor_core_cost(r, c, 8, n, square, depth)
        want = jcm.tensor_core_cost(r, c, 8, n, square, depth)
        assert (got.name, got.area, got.squarers, got.multipliers) == \
            (want.name, want.area, want.squarers, want.multipliers)


def test_savings_table_and_ratio_equal_jax():
    for depth in (64, 1024):
        assert tcm.savings_table((4, 8, 16, 32), depth) == \
            jcm.savings_table((4, 8, 16, 32), depth)
    a, b = tcm.pm_mac_cost(8), tcm.mac_cost(8)
    assert a.ratio_to(b) == jcm.pm_mac_cost(8).ratio_to(jcm.mac_cost(8)) < 1


def test_route_terms_equal_jax():
    for m, n, k, kc in itertools.product((1, 8, 33), (1, 64, 129),
                                         (1, 16, 4096), (1, 8, 32)):
        assert tcm.pm_tile_vpu_ops(m, n, k, kc) == \
            jcm.pm_tile_vpu_ops(m, n, k, kc)
    for args in itertools.product((1, 7, 56), (1, 30), (1, 3), (1, 5),
                                  (1, 64)):
        for batch, item in ((1, 4), (8, 2)):
            assert tcm.conv2d_patch_bytes(*args, batch=batch,
                                          itemsize=item) == \
                jcm.conv2d_patch_bytes(*args, batch=batch, itemsize=item)
    for t, kv, hd, batch in itertools.product((16, 1024), (1, 12), (64, 128),
                                              (1, 8)):
        assert tcm.paged_attn_gather_bytes(t, kv, hd, batch=batch) == \
            jcm.paged_attn_gather_bytes(t, kv, hd, batch=batch)
    # the route planner reads them from the cost model
    assert routing.conv2d_patch_bytes is tcm.conv2d_patch_bytes


def test_launch_cost_waves_and_occupancy():
    """Blocks an SM holds: 2048 threads, 32 blocks and 228 KB of shared
    memory (1 KB reserved a block) bound it; a grid of that many blocks a
    SM is one full wave."""
    c = tcm.LaunchCost(blocks=132 * 8, threads=256, smem_bytes=0,
                       fp32_slots=0.0, bytes=0.0)
    assert (c.resident, c.waves, c.occupancy) == (8, 1, 1.0)
    c = tcm.LaunchCost(blocks=132 * 2 + 1, threads=128,
                       smem_bytes=100 * 1024, fp32_slots=0.0, bytes=0.0)
    assert (c.resident, c.waves) == (2, 2)
    assert c.occupancy == pytest.approx((132 * 2 + 1) / (2 * 132 * 2))
    c = tcm.LaunchCost(blocks=1, threads=1024, smem_bytes=0,
                       fp32_slots=tcm.FP32_SLOTS_PER_S * 1e-3,
                       bytes=tcm.HBM_BYTES_PER_S * 2e-3)
    assert c.slot_ms == pytest.approx(1.0) and c.byte_ms == pytest.approx(2.0)
    assert c.predicted_ms == pytest.approx(max(1.0 / c.occupancy, 2.0))


def test_kernel_costs_follow_their_variants():
    """K1's 32 x 128 tile at m = 8 pads 24 rows of every tile: 4x the
    slots of the 8 x 64 tile's; K2's 1-row tile at m = 1 pads nothing;
    K4's blocks scale with its splits; K5's own tile stages 16-deep slabs,
    the 1 x 1 tile 64-deep ones."""
    small, big = tcm.k1_cost(8, 768, 768, 8, 64), \
        tcm.k1_cost(8, 768, 768, 32, 128)
    assert big.fp32_slots == 4 * small.fp32_slots
    assert (small.blocks, big.blocks) == (8 * 12, 8 * 6)
    assert small.bytes == big.bytes == 4 * (8 * 768 * 2 + 768 * 768
                                            + 8 + 768)
    one = tcm.batched_cost(48, 1, 128, 64, 1, 64)
    four = tcm.batched_cost(48, 1, 128, 64, 4, 64)
    assert four.fp32_slots == 4 * one.fp32_slots and one.blocks == 96
    assert [tcm.paged_attn_cost(8, 1, 12, 1, 64, 8, 16, z, 4096).blocks
            for z in (1, 8)] == [96, 768]
    own = tcm.cpm_cost(4096, 1024, 1024, (8, 4), (3, 3), 6, (8, 4))
    unit = tcm.cpm_cost(4096, 1024, 1024, (1, 1), (3, 3), 6, (8, 4))
    assert (own.blocks, unit.blocks) == (32 * 16, 256 * 64)
    assert own.smem_bytes == 4 * 2 * 16 * (3 * 128 + 3 * 64)
    assert unit.smem_bytes == 4 * 2 * 64 * (3 * 16 + 3 * 16)
