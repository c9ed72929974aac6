"""K5's and K6's launch rule on the CPU: the Python mirrors
(``k5_launch_shape``, ``k6_launch_shape``) against the tile rule of
``src/repro_torch/csrc/cpm_tile.cuh``, and the sources' square counts.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cpm3_matmul as k5mod  # noqa: E402
from repro_torch.kernels import cpm4_matmul as k6mod  # noqa: E402
from repro_torch.kernels.cpm3_matmul import k5_launch_shape  # noqa: E402
from repro_torch.kernels.cpm4_matmul import k6_launch_shape  # noqa: E402

CSRC = Path(repro_torch.__file__).parent / "csrc"
SHAPES = [k5_launch_shape, k6_launch_shape]


@pytest.mark.parametrize("launch_shape,tile,grid", [
    (k5_launch_shape, (8, 4), (32, 16)),      # 128 x 64 a block
    (k6_launch_shape, (4, 4), (64, 16))])     # 64 x 64 a block
def test_dft_shape_takes_the_register_tile(launch_shape, tile, grid):
    """The batched DFT (4096 x 1024 x 1024) takes each kernel's own thread
    tile: 512 blocks of 128 x 64 outputs for K5, 1024 of 64 x 64 for K6."""
    assert launch_shape(4096, 1024) == {
        "rows": 16 * tile[0], "cols": 16 * tile[1], "thread_tile": tile,
        "grid": grid}


@pytest.mark.parametrize("launch_shape,own", [(k5_launch_shape, (8, 4)),
                                              (k6_launch_shape, (4, 4))])
@pytest.mark.parametrize("m,n,small", [
    (64, 64, (1, 1)),            # 64^3: 16 blocks at 1 x 1
    (512, 512, (1, 1)),          # 32 or 64 blocks at the own tile
    (256, 256, (1, 1)),          # 8 or 16 blocks at the own tile
    (1100, 1030, None),          # ragged edges: 153 or 306 blocks
    (4096, 1024, None),
    (129, 65, (1, 1)),
    (128, 64, (1, 1)),
    (1, 1, (1, 1)),
    (1, 100000, None),           # one row: 1563 or 6250 column tiles
])
def test_tile_rule(launch_shape, own, m, n, small):
    """A kernel's own thread tile where its grid has 128 blocks, else
    1 x 1."""
    tile = small or own
    shape = launch_shape(m, n)
    assert shape["thread_tile"] == tile
    assert (shape["rows"], shape["cols"]) == (16 * tile[0], 16 * tile[1])
    own_blocks = -(-m // (16 * own[0])) * -(-n // (16 * own[1]))
    assert (own_blocks >= 128) == (tile == own)


@pytest.mark.parametrize("launch_shape", SHAPES)
@pytest.mark.parametrize("m,n", [(1, 1), (17, 31), (64, 64), (129, 65),
                                 (128, 64), (500, 510), (4096, 1024),
                                 (4097, 1023), (1100, 1030), (33, 5000)])
def test_tiles_cover_the_output_exactly(launch_shape, m, n):
    """The grid covers m and n with no tile wholly past the edge."""
    shape = launch_shape(m, n)
    gx, gy = shape["grid"]
    assert gx * shape["rows"] >= m > (gx - 1) * shape["rows"]
    assert gy * shape["cols"] >= n > (gy - 1) * shape["cols"]


def test_cpm_launch_constants_match_source():
    """The mirrors read what the CUDA sources launch with: the block of 16 x
    16 threads, each kernel's own thread tile (plan code 0) and the small
    tile (code 1).  The block floor of the rule is the planner's model
    mode, in Python: the source takes the tile from its caller."""
    from repro_torch.kernels import tuning
    src = (CSRC / "cpm_tile.cuh").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["THREADS"] == k5mod._BLOCK_THREADS ** 2 == 256
    assert "TILE_MIN_BLOCKS" not in consts and k5mod._TILE_MIN_BLOCKS == 128
    assert "constexpr int BM = 16 * TM, BN = 16 * TN;" in src
    assert "if (tile == 0) return launch_vec<Op, Op::TILE_M, Op::TILE_N, " \
           "16>(p" in src
    small = re.findall(r"if \(tile == 1\) return launch_vec<Op, (\d+), "
                       r"(\d+), \d+>\(p", src)
    assert [(int(a), int(b)) for a, b in small] == [k5mod._SMALL_TILE]
    assert [p.thread_tile for p in tuning.candidates_cpm(
        "cpm3_matmul", 64, 64)] == [k5mod.K5_TILE, k5mod._SMALL_TILE]
    for name, tile in (("cpm3_matmul", k5mod.K5_TILE),
                       ("cpm4_matmul", k6mod.K6_TILE)):
        cu = (CSRC / f"{name}.cu").read_text()
        assert '#include "cpm_tile.cuh"' in cu
        assert re.search(r"return cpm::launch<Cpm[34]>\(p, ", cu)
        own = re.search(r"TILE_M = (\d+), TILE_N = (\d+);", cu)
        assert (int(own[1]), int(own[2])) == tile


def _term(name: str) -> str:
    cu = (CSRC / f"{name}.cu").read_text()
    return re.search(r"static void term\(.*?\n  \}\n", cu, re.S).group(0)


@pytest.mark.parametrize("name,squares", [("cpm3_matmul", 3),
                                          ("cpm4_matmul", 4)])
def test_kernel_term_square_count(name, squares):
    """K5 issues the paper's three squares a complex term (c+a+b squared
    once, shared by both planes), K6 its four."""
    term = _term(name)
    assert term.count("fmaf(") == squares
    assert "*" not in term.split("{", 1)[1]
    if name == "cpm3_matmul":
        assert term.count("fmaf(t, t,") == 1


def test_ptxas_usage_parses_a_report():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooILi8ELi4ELb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi8ELi4ELb1EEvv
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""
    assert build.ptxas_usage(text) == [
        {"entry": "_Z3fooILi8ELi4ELb1EEvv", "spill_stores": 8,
         "spill_loads": 12, "registers": 168},
        {"entry": "_Z3barv", "spill_stores": 0, "spill_loads": 0,
         "registers": 40}]


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited header gives the sources that include it a new library
    name, so a stale build is never loaded."""
    for f in ("cpm3_matmul.cu", "cpm_tile.cuh"):
        (tmp_path / f).write_text((CSRC / f).read_text())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    before = build._library_path("cpm3_matmul")
    (tmp_path / "cpm_tile.cuh").write_text(
        (CSRC / "cpm_tile.cuh").read_text() + "\n// edited\n")
    assert build._library_path("cpm3_matmul") != before
