"""Analytical cost model: the PyTorch port of ``repro/core/cost_model.py``.

Two halves.

- **The paper's gate-area model**, unchanged (:class:`ArithCost`,
  :func:`mac_cost`, :func:`pm_mac_cost`, :func:`complex_mac_cost`,
  :func:`cpm4_cost`, :func:`cpm3_cost`, :func:`systolic_array_cost`,
  :func:`tensor_core_cost`, :func:`savings_table`): an area proxy in
  full-adder-equivalents for multiplier-based vs square-based MACs,
  systolic arrays, tensor cores and complex multipliers.  Conventions: an
  n x n array multiplier costs n^2, a squarer n^2 / 2 (paper ref [1]), an
  adder and a register n; the PM operand adder works on n + 1 bits and the
  accumulators are 2n + log2(K) wide.  It is plain arithmetic, kept here
  as the port's own copy.
- **The H100 launch model**, the counterpart of the JAX package's Pallas
  tile terms (``TileCost``, ``pm_tile_vmem_bytes``, ``pm_grid_cost``, which
  price VMEM tiles): :class:`LaunchCost` prices one launch of a CUDA
  kernel's variant by its blocks in waves over the card's SMs, its shared
  memory a block (which sets how many blocks an SM holds), its FP32 issue
  slots (an add and an fma a square term: the slots set the square
  kernels' floor on the card) and its bytes (each operand read
  once, the output written once).  ``kernels/tuning.py`` ranks a kernel's
  plan variants with it before it times them.  Registers are not modelled
  (no kernel of the port spills; the compiler's report is read on the
  card).

Also the byte terms the route rules read (:func:`conv2d_patch_bytes`,
:func:`paged_attn_gather_bytes`) and the PM lane-op count of the fold rule
(:func:`pm_tile_vpu_ops`), under the JAX package's names.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ArithCost", "mac_cost", "pm_mac_cost", "complex_mac_cost",
           "cpm4_cost", "cpm3_cost", "systolic_array_cost",
           "tensor_core_cost", "savings_table", "pm_tile_vpu_ops",
           "conv2d_patch_bytes", "paged_attn_gather_bytes", "LaunchCost",
           "H100_SMS", "HBM_BYTES_PER_S", "FP32_FLOPS_PER_S",
           "FP32_SLOTS_PER_S", "INT32_SLOTS_PER_S", "BF16_TENSOR_FLOPS_PER_S",
           "NVLINK_BYTES_PER_S",
           "k1_cost", "batched_cost", "paged_attn_cost", "cpm_cost",
           "conv2d_cost"]


@dataclasses.dataclass(frozen=True)
class ArithCost:
    name: str
    area: float          # FA-equivalents
    squarers: int = 0
    multipliers: int = 0
    adders: int = 0

    def ratio_to(self, other: "ArithCost") -> float:
        return self.area / other.area


def _mult_area(n: int) -> float:
    return float(n * n)


def _sq_area(n: int) -> float:
    return float(n * n) / 2.0


def _add_area(n: int) -> float:
    return float(n)


def _acc_bits(n: int, depth: int) -> int:
    return 2 * n + max(1, math.ceil(math.log2(max(2, depth))))


def mac_cost(n: int, depth: int = 1024) -> ArithCost:
    """Multiplier MAC (paper Fig.1a): n x n multiplier + accumulator adder."""
    acc = _acc_bits(n, depth)
    area = _mult_area(n) + _add_area(acc) + acc
    return ArithCost("mac", area, multipliers=1, adders=1)


def pm_mac_cost(n: int, depth: int = 1024) -> ArithCost:
    """Partial-multiplication MAC (paper Fig.1b): operand adder + squarer +
    accumulator.  The squarer sees n+1 bits (sum growth)."""
    acc = _acc_bits(n + 1, depth)
    area = _add_area(n + 1) + _sq_area(n + 1) + _add_area(acc) + acc
    return ArithCost("pm_mac", area, squarers=1, adders=2)


def complex_mac_cost(n: int, depth: int = 1024) -> ArithCost:
    """Complex MAC via 3 real multipliers (paper Fig.9b, Karatsuba form)."""
    acc = _acc_bits(n + 1, depth)
    area = 3 * _mult_area(n + 1) + 5 * _add_area(n + 1) \
        + 2 * (_add_area(acc) + acc)
    return ArithCost("complex_mac3", area, multipliers=3, adders=7)


def cpm4_cost(n: int, depth: int = 1024) -> ArithCost:
    """CPM with 4 squarers (paper Fig.9a): 4 operand adders + 4 squarers +
    2 combine adders + 2 accumulators."""
    acc = _acc_bits(n + 1, depth)
    area = 4 * (_add_area(n + 1) + _sq_area(n + 1)) \
        + 2 * _add_area(2 * (n + 1)) + 2 * (_add_area(acc) + acc)
    return ArithCost("cpm4", area, squarers=4, adders=8)


def cpm3_cost(n: int, depth: int = 1024) -> ArithCost:
    """CPM3 (paper Fig.12a): 3 squarers on (n+2)-bit three-operand sums,
    shared square reused by both output planes."""
    acc = _acc_bits(n + 2, depth)
    area = 3 * (_sq_area(n + 2)) + 5 * _add_area(n + 2) \
        + 2 * _add_area(2 * (n + 2)) + 2 * (_add_area(acc) + acc)
    return ArithCost("cpm3", area, squarers=3, adders=9)


def systolic_array_cost(rows: int, cols: int, n: int, square: bool,
                        depth: int = 1024) -> ArithCost:
    """Weight-stationary systolic array (paper Fig.2/3): each PE holds
    REGA + mux + compute; the square version adds the Sa/Sb injection path
    (one adder) at the array periphery per column."""
    pe = pm_mac_cost(n, depth) if square else mac_cost(n, depth)
    periph = cols * _add_area(_acc_bits(n + 1, depth)) if square else 0.0
    area = rows * cols * (pe.area + n) + periph          # + REGA register
    return ArithCost("sq_systolic" if square else "mac_systolic", area,
                     squarers=pe.squarers * rows * cols,
                     multipliers=pe.multipliers * rows * cols)


def tensor_core_cost(m: int, n_dim: int, k: int, n: int, square: bool,
                     depth: int = 1024) -> ArithCost:
    """Tensor core (paper Fig.4/5): M*P PEs each with a K-wide dot-product
    reduction tree; the square version initializes accumulators with
    Sa+Sb."""
    acc = _acc_bits(n + 1, depth)
    if square:
        unit = _add_area(n + 1) + _sq_area(n + 1)        # PM unit
    else:
        unit = _mult_area(n)
    tree = (k - 1) * _add_area(acc)
    pe = k * unit + tree + _add_area(acc) + acc
    area = m * n_dim * pe
    return ArithCost("sq_tensor_core" if square else "mac_tensor_core", area,
                     squarers=(k * m * n_dim if square else 0),
                     multipliers=(0 if square else k * m * n_dim))


def savings_table(bitwidths=(8, 16, 32), depth: int = 1024):
    """Area ratios (square-based / multiplier-based) per paper
    architecture."""
    rows = []
    for n in bitwidths:
        rows.append({
            "bits": n,
            "pm_mac/mac": pm_mac_cost(n, depth).ratio_to(mac_cost(n, depth)),
            "cpm4/cmac3": cpm4_cost(n, depth).ratio_to(
                complex_mac_cost(n, depth)),
            "cpm3/cmac3": cpm3_cost(n, depth).ratio_to(
                complex_mac_cost(n, depth)),
            "sq_systolic/mac_systolic(128x128)":
                systolic_array_cost(128, 128, n, True, depth).ratio_to(
                    systolic_array_cost(128, 128, n, False, depth)),
            "sq_tcore/mac_tcore(8x8x8)":
                tensor_core_cost(8, 8, 8, n, True, depth).ratio_to(
                    tensor_core_cost(8, 8, 8, n, False, depth)),
        })
    return rows


def pm_tile_vpu_ops(m: int, n: int, k: int, kc: int,
                    ops_per_pm: int = 3) -> float:
    """PM lane-ops of an (m, n, k) contraction: ``ops_per_pm`` a term
    (operand add, square, accumulate) and one plane add a ``kc``-wide
    chunk.  The matmul route rule's fold threshold is stated in it."""
    return float(m) * n * k * (ops_per_pm + 1.0 / max(1, kc))


def conv2d_patch_bytes(oh: int, ow: int, kh: int, kw: int, cin: int,
                       batch: int = 1, itemsize: int = 4) -> int:
    """Bytes of the materialised im2col patch matrix ``(B*oh*ow,
    cin*kh*kw)``: the blowup the fused conv kernel avoids.  The conv route
    rule keys the fused-vs-im2col choice on whether it stays
    cache-resident."""
    return batch * oh * ow * cin * kh * kw * itemsize


def paged_attn_gather_bytes(t: int, kv_heads: int, hd: int, *,
                            batch: int = 1, itemsize: int = 4) -> int:
    """Bytes the dense paged read moves to materialise the gathered
    ``(B, T, KV, hd)`` K and V windows (the pool read and the gathered
    copy's write, both tensors): the traffic the block-streaming kernel
    avoids.  It scales with the table's length ``t``, not live context."""
    return 2 * 2 * batch * t * kv_heads * hd * itemsize


# --------------------------------------------------------------------------
# The H100 launch model
# --------------------------------------------------------------------------

# H100 SXM5 80GB at 700 W (NVIDIA data sheet, not measured): SMs, the HBM3
# rate, the CUDA-core FP32 rate outside the tensor cores, the dense BF16
# tensor-core rate and NVLink's rate a direction.  An FP32 add takes an
# issue slot as an fma does, so the slot rate is half the FLOP rate; an
# sm_90 SM issues 64 INT32 lanes a clock against 128 FP32, so the INT32
# slot rate is half the FP32 one.
H100_SMS = 132
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_SLOTS_PER_S = FP32_FLOPS_PER_S / 2
INT32_SLOTS_PER_S = FP32_SLOTS_PER_S / 2
BF16_TENSOR_FLOPS_PER_S = 989.4e12
NVLINK_BYTES_PER_S = 450e9
SMEM_PER_SM = 228 * 1024          # bytes; 1 KB of it is reserved a block
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32


@dataclasses.dataclass(frozen=True)
class LaunchCost:
    """One launch of a kernel variant over the whole call."""
    blocks: int            # grid size
    threads: int           # a block
    smem_bytes: int        # shared memory a block
    fp32_slots: float      # issue slots of the whole launch (padded tiles)
    bytes: float           # each operand read once, the output written once
    sms: int = H100_SMS

    @property
    def resident(self) -> int:
        """Blocks an SM holds at once, by threads and shared memory."""
        by_smem = SMEM_PER_SM // (self.smem_bytes + 1024)
        return max(1, min(BLOCKS_PER_SM, THREADS_PER_SM // self.threads,
                          by_smem))

    @property
    def waves(self) -> int:
        return -(-self.blocks // (self.sms * self.resident))

    @property
    def occupancy(self) -> float:
        """The share of the waves' block slots the grid fills."""
        return self.blocks / (self.waves * self.sms * self.resident)

    @property
    def slot_ms(self) -> float:
        return self.fp32_slots / FP32_SLOTS_PER_S * 1e3

    @property
    def byte_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def predicted_ms(self) -> float:
        """A ranking, not a prediction of wall time: the slot floor
        stretched by the waves' unfilled share, or the byte floor,
        whichever is larger.  Used to order variants only."""
        return max(self.slot_ms / self.occupancy, self.byte_ms)


def _up(x: int, q: int) -> int:
    return -(-x // q) * q


def k1_cost(m: int, n: int, k: int, rows: int, cols: int,
            itemsize: int = 4) -> LaunchCost:
    """K1 with an output tile of ``rows`` x ``cols``: 8 blocks (partials) a
    tile, 4 or 16 warps a block, a STAGES-deep ring of 32-row slabs of b
    and the tile's a values in shared memory (``csrc/sq_matmul.cu``)."""
    warps, stages = (4, 6) if rows == 8 else (16, 4)
    smem = itemsize * (stages * 32 * (cols + rows) + rows * cols)
    blocks = 8 * -(-n // cols) * -(-m // rows)
    return LaunchCost(blocks, 32 * warps, smem,
                      2.0 * _up(m, rows) * _up(n, cols) * _up(k, 64),
                      itemsize * (m * k + k * n + m * n + m + n))


def batched_cost(nb: int, m: int, n: int, k: int, rows: int, cols: int,
                 itemsize: int = 4) -> LaunchCost:
    """K2 / K3 with an R x C tile: one block of 8 warps a (element, row
    tile, column tile), R rows of a staged for a 128-deep chunk and the 8
    partial tiles in shared memory."""
    smem = itemsize * (8 * rows * 16 + 8 * rows * cols)
    blocks = nb * -(-n // cols) * -(-m // rows)
    return LaunchCost(blocks, 256, smem,
                      2.0 * nb * _up(m, rows) * _up(n, cols) * _up(k, 64),
                      itemsize * nb * (m * k + k * n + m * n + m + n))


def paged_attn_cost(batch: int, s: int, kv_heads: int, group: int, hd: int,
                    nb: int, block_size: int, splits: int, smem_bytes: int,
                    itemsize: int = 4) -> LaunchCost:
    """K4 with the table walked in ``splits`` ranges: a block of min(4,
    S*G) warps a (kv-head, sequence, split); the square-form scores and PV
    are 2 slots a term each over the S*G rows and the T = nb * block_size
    positions; the bytes are the K/V blocks, positions and queries."""
    rows, t = s * group, nb * block_size
    return LaunchCost(kv_heads * batch * splits, 32 * min(4, rows),
                      smem_bytes, 2.0 * 2 * batch * kv_heads * rows * t * hd,
                      batch * kv_heads * (2 * t * hd * itemsize + 4 * t)
                      + 4 * 2 * batch * kv_heads * rows * hd)


def cpm_cost(m: int, n: int, k: int, thread_tile, planes, slots_a_term: int,
             own_tile) -> LaunchCost:
    """K5 / K6 (``csrc/cpm_tile.cuh``): 16 x 16 threads a block, a thread
    tile of outputs, 2 stages of BK-deep slabs of the row and column planes
    in shared memory (BK 16 with the kernel's own tile, 64 with 1 x 1);
    ``slots_a_term`` (6 for CPM3, 8 for CPM4) per complex term."""
    tm, tn = thread_tile
    bk = 16 if tuple(thread_tile) == tuple(own_tile) else 64
    bm, bn = 16 * tm, 16 * tn
    smem = 4 * 2 * bk * (planes[0] * bm + planes[1] * bn)
    blocks = -(-m // bm) * -(-n // bn)
    return LaunchCost(blocks, 256, smem,
                      float(slots_a_term) * _up(m, bm) * _up(n, bn) * k,
                      4.0 * (2 * m * k + 2 * k * n + 2 * m * n))


def conv2d_cost(launch: dict, batch: int, cin: int, cout: int, oh: int,
                ow: int, kh: int, kw: int, h: int, w: int,
                itemsize: int = 4) -> LaunchCost:
    """K7 at one of its launches (``kernels/sq_conv2d.py::k7_launch_shape``'s
    form): 128 threads a block, 64 pixels x 64 filters a tile, 2 slots a
    square term over the tiles' padded pixels and filters; a split tile
    also writes and reads back its partials."""
    gx, gy, gz = launch["grid"]
    pixels = gx * launch["pixels"]
    terms = float(pixels) * _up(cout, 64) * kh * kw * cin
    partial = 2 * gx * gy * gz * 64 * 64 * itemsize if gz > 1 else 0
    return LaunchCost(gx * gy * gz, 128, launch["smem"], 2.0 * terms,
                      itemsize * (batch * cin * h * w + kh * kw * cin * cout
                                  + batch * cout * oh * ow + cout)
                      + partial)
