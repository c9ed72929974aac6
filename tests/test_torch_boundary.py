"""The port's package boundary and device contract.

- No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro``.
- ``import repro_torch`` (every module) leaves ``jax`` out of
  ``sys.modules``.
- The entry points run on CUDA unless the caller names a device: with no
  device and no GPU they raise, they never carry on on the CPU.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sq_paged_attn import sq_paged_attn  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.serve.engine import Engine, EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                  .parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m.rstrip('.')}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nprint(bad)\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_device_raise(no_cuda):
    cfg = get_config("fairsquare-demo").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sq_matmul(torch.ones(2, 3), torch.ones(3, 4))
    q = torch.zeros(1, 1, 1, 1, 4)
    pool = torch.zeros(8, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sq_paged_attn(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                      torch.zeros(8, dtype=torch.int32),
                      torch.zeros(1, 1, dtype=torch.int32), block_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--requests", "1", "--max-new", "2"])


def test_conv_entry_points_without_a_device_raise(no_cuda):
    """Numpy operands go to CUDA unless the caller names a device: with no
    GPU the conv entry points raise; with device="cpu" they run."""
    import numpy as np
    from repro_torch.core import conv as tconv
    x = np.ones((1, 2, 6, 6), np.float32)
    w = np.ones((3, 2, 3, 3), np.float32)
    for mode in tconv.CONV2D_MODES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconv.conv2d(x, w, mode=mode)
        assert tconv.conv2d(x, w, mode=mode, device="cpu").shape == \
            (1, 3, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sq_conv(np.ones(10, np.float32), np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.correlate1d(np.ones(10, np.float32), np.ones(3, np.float32),
                          mode="square")
    assert ops.sq_conv(np.ones(10, np.float32), np.ones(3, np.float32),
                       device="cpu").shape == (8,)


def test_complex_entry_points_without_a_device_raise(no_cuda):
    """Numpy operands of the complex matmuls and transforms go to CUDA
    unless the caller names a device: with no GPU they raise; with
    device="cpu" they run."""
    import numpy as np
    from repro_torch.core import complexmm, transforms
    x = np.ones((2, 3), np.complex64)
    y = np.ones((3, 4), np.complex64)
    for f in (ops.cpm3_matmul, ops.cpm4_matmul):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            f(x, y)
        re, im = f(x, y, device="cpu")
        assert re.shape == im.shape == (2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        complexmm.cpm3_matmul(x, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transforms.dft_matrix(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transforms.ComplexSquareTransform(np.ones((4, 4), np.complex64))
    assert transforms.dft_matrix(8, device="cpu").shape == (8, 8)


def test_engine_refuses_a_model_on_another_device(no_cuda):
    model = build_model(get_config("fairsquare-demo").reduced(),
                        device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        Engine(model, EngineConfig(), device="meta")


def test_serve_launcher_runs_on_an_explicit_cpu_device(capsys):
    res = tserve.main(["--reduced", "--device", "cpu", "--matmul-mode",
                       "square_pallas", "--policy", "square_gemms",
                       "--prepared", "--requests", "3", "--max-new", "3"])
    assert len(res) == 3 and all(r.ok and len(r.tokens) == 3
                                 for r in res.values())
    assert "device=cpu" in capsys.readouterr().out


def test_unported_archs_raise_naming_the_slice():
    """Every registry arch builds: paligemma (prefix tokens) serves
    through the launcher's fallback to the dense Server and keeps refusing
    the paged cache, as JAX does; whisper builds its encoder and its
    ``xdec`` decoder.  A block kind the port lacks is still refused."""
    from repro_torch.configs.registry import ARCHS
    for name in ARCHS:
        assert build_model(get_config(name).reduced(), device="cpu")
    model = build_model(get_config("paligemma-3b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="prefix-token archs use the dense"):
        model.init_paged_cache(64)
    res = tserve.main(["--arch", "paligemma-3b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "2"])
    assert sorted(res) == [0, 1] and all(len(t) == 2 for t in res.values())
    model = build_model(get_config("whisper-large-v3").reduced(),
                        device="cpu")
    assert model.kinds == ("xdec",) * model.cfg.n_layers
    assert len(model.encoder["layers"]) == model.cfg.encoder_layers
    odd = dataclasses.replace(get_config("fairsquare-demo").reduced(),
                              block_pattern=("conv",))
    with pytest.raises(NotImplementedError, match="is not ported"):
        build_model(odd, device="cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path, alone):
    """No result without a GPU, and none from a directory holding
    chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_device_and_roofline_modules_are_in_the_boundary(no_cuda):
    """The mesh, sharding, collectives, analyzer, report and dry-run
    modules are among the files the import checks above walk, and they
    need no GPU: a single process has no local mesh, the production
    meshes are abstract, and the dry run prices a cell on ``meta`` (only
    where the caller asks for it: the model entry points still refuse to
    carry on on the CPU)."""
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"distributed/context.py", "distributed/sharding.py",
            "distributed/collectives.py", "launch/mesh.py",
            "launch/dryrun.py", "roofline/op_analysis.py",
            "roofline/report.py", "kernels/meta.py"} <= files
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, mesh
    assert mesh.make_local_mesh() is None
    assert mesh.make_production_mesh(multi_pod=True).size == 512
    cell = dryrun.dryrun_cell("fairsquare-demo",
                              ShapeConfig("t", 16, 2, "decode"),
                              overrides={"_reduced": True}, verbose=False)
    assert cell["dot_flops_per_device"] > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("fairsquare-demo").reduced())
