"""The port's square-routed ``fs_einsum`` VJP against the JAX package
(the contract of ``tests/test_vjp_square.py``).

- Call-site gradients, every mode x every spec of
  ``test_einsum_dispatch.CALL_SITE_SPECS``: the port's ``autograd`` grads
  against ``jax.grad`` of the same contraction on the same numpy operands.
  f32 within 1e-5 (tiny contraction depths: reassociation error is O(K)
  ulps); bf16 grads stay bf16 and match at 5e-2 against JAX's grads of the
  same bf16-rounded operands (the JAX suite's stance: operands quantize
  before either route runs).
- Second-order gradients (the backward is itself differentiable), the
  prepared transposed logits with ``prepare_grads=True``, backward sites
  audited and overridable by policy, ``$REPRO_EINSUM_VJP=0`` (mechanical
  grads for the torch-level modes; ``square_pallas`` raises), and the
  saturating backward that demotes only ``chaos.bwd_*`` under the guard.
- The square form's dynamic-range gap in the backward (activations ~5
  against cotangents ~1e-4, as at full width): the port's gradients are
  off the exact product by as much as the JAX package's own, its Pallas
  kernel in interpret mode included, and the gap closes alike in both when
  the cotangent is scaled by a power of two.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.einsum import fs_einsum as jeinsum  # noqa: E402
from repro_torch.configs.base import ContractionPolicy  # noqa: E402
from repro_torch.core import counting, guards  # noqa: E402
from repro_torch.core.einsum import fs_einsum, vjp_enabled  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.core.prepared import prepare_operand  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

from test_einsum_dispatch import CALL_SITE_SPECS  # noqa: E402

RNG = np.random.default_rng(31)

# The JAX package's Pallas wrappers pass ``pltpu.TPUCompilerParams``, which
# JAX 0.9.0 renamed ``CompilerParams``; the alias is made once, when this
# file is collected (as in ``test_torch_complex.py``), so that its Pallas
# matmul runs in interpret mode here.
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams


@pytest.fixture(autouse=True)
def _clean_health():
    routing.reset_route_health()
    yield
    routing.reset_route_health()


def _operands(spec, xs, ys):
    x = RNG.normal(size=xs).astype(np.float32)
    y = RNG.normal(size=ys).astype(np.float32)
    cot = RNG.normal(size=np.einsum(spec, x, y).shape).astype(np.float32)
    return x, y, cot


def _jax_grads(spec, x, y, cot):
    c = jnp.asarray(cot)
    loss = lambda x, y: jnp.sum(                                # noqa: E731
        jnp.einsum(spec, x, y).astype(jnp.float32) * c)
    return jax.grad(loss, argnums=(0, 1))(x, y)


def _torch_grads(spec, x, y, cot, **kw):
    x = x.clone().requires_grad_(True)
    y = y.clone().requires_grad_(True)
    out = fs_einsum(spec, x, y, **kw)
    loss = torch.sum(out.float() * torch.from_numpy(cot))
    return torch.autograd.grad(loss, (x, y))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec,xs,ys", CALL_SITE_SPECS,
                         ids=[s for s, _, _ in CALL_SITE_SPECS])
def test_call_site_grads_f32(spec, xs, ys, mode):
    x, y, cot = _operands(spec, xs, ys)
    dx, dy = _torch_grads(spec, torch.from_numpy(x), torch.from_numpy(y),
                          cot, mode=mode)
    rx, ry = _jax_grads(spec, jnp.asarray(x), jnp.asarray(y), cot)
    assert dx.dtype == torch.float32 and dy.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(rx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dy.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec,xs,ys", CALL_SITE_SPECS[:10],
                         ids=[s for s, _, _ in CALL_SITE_SPECS[:10]])
def test_call_site_grads_bf16(spec, xs, ys, mode):
    x, y, cot = _operands(spec, xs, ys)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    rx, ry = _jax_grads(spec, xb, yb, cot)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    ty = torch.from_numpy(np.asarray(yb, np.float32)).bfloat16()
    dx, dy = _torch_grads(spec, tx, ty, cot, mode=mode)
    assert dx.dtype == torch.bfloat16 and dy.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(rx, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(dy.float().numpy(), np.asarray(ry, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_square_virtual_grads_match_jax_fs_einsum():
    """The port's VJP against the JAX package's own custom VJP (not only
    the multiplier reference), with the backward sites noted the same."""
    spec, xs, ys = "bsd,vd->bsv", (2, 4, 5), (9, 5)
    x, y, cot = _operands(spec, xs, ys)
    c = jnp.asarray(cot)
    from repro.core import counting as jcount
    with jcount.track_contractions() as jctr:
        rx, ry = jax.grad(lambda x, y: jnp.sum(jeinsum(
            spec, x, y, mode="square_virtual", site="logits") * c),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    with counting.track_contractions() as ctr:
        dx, dy = _torch_grads(spec, torch.from_numpy(x), torch.from_numpy(y),
                              cot, mode="square_virtual", site="logits")
    np.testing.assert_allclose(dx.numpy(), np.asarray(rx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dy.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    assert {k: v["mults"] for k, v in ctr.by_site().items()} == \
        {k: v["mults"] for k, v in jctr.by_site().items()}


def test_second_order_grads_match():
    """grad-of-grad re-enters the VJP: a Hessian-vector product of a
    square-routed quadratic matches JAX's."""
    x = RNG.normal(size=(3, 4)).astype(np.float32)
    w = RNG.normal(size=(4, 2)).astype(np.float32)
    jw = jnp.asarray(w)
    g = lambda x: jnp.sum(jnp.einsum("mk,kn->mn", x, jw) ** 2)  # noqa: E731
    ref = jax.grad(lambda x: jnp.sum(jax.grad(g)(x) * x))(jnp.asarray(x))
    tw = torch.from_numpy(w)
    for mode in ("square_virtual", "square_exact", "square_pallas"):
        tx = torch.from_numpy(x).requires_grad_(True)
        with counting.track_contractions() as ctr:
            f = torch.sum(fs_einsum("mk,kn->mn", tx, tw, mode=mode,
                                    site="ffn") ** 2)
            gx, = torch.autograd.grad(f, tx, create_graph=True)
            hvp, = torch.autograd.grad(torch.sum(gx * tx), tx)
        np.testing.assert_allclose(hvp.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        # the second order differentiates the backward's own contraction
        assert "ffn.bwd_x.bwd_x" in ctr.by_site()
        assert ctr.fraction_square == 1.0


def test_prepared_transposed_logits_grads():
    """The tied vocab GEMM with a gradient-prepared weight: dL/dx contracts
    the opposite-layout ``grad`` prep, dL/dW reaches the prep's source,
    and both backward contractions are square-routed sites."""
    x = RNG.normal(size=(6, 5)).astype(np.float32)
    w = RNG.normal(size=(9, 5)).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    prep = prepare_operand(tw, transpose=True, site="logits",
                           prepare_grads=True)
    assert prep.grad is not None and prep.grad.transposed is False
    assert prep.grad.site == "logits.bwd_x"
    for mode in ("square_virtual", "square_pallas"):
        with counting.track_contractions() as ctr:
            loss = torch.sum(fs_einsum("td,vd->tv", tx, prep, mode=mode,
                                       site="logits") ** 2)
            dx, dw = torch.autograd.grad(loss, (tx, tw))
        rx, rw = jax.grad(lambda x, w: jnp.sum(jnp.einsum(
            "td,vd->tv", x, w) ** 2), argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
        np.testing.assert_allclose(dx.numpy(), np.asarray(rx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), np.asarray(rw), rtol=1e-5,
                                   atol=1e-5)
        assert {"logits", "logits.bwd_x", "logits.bwd_w"} <= \
            set(ctr.by_site())
        assert ctr.fraction_square_bwd == 1.0


def test_bwd_sites_audited_and_policy_overridable():
    """``<site>.bwd_x`` inherits the forward site's pin; ``<site>.bwd_w``
    takes its own override."""
    x = torch.from_numpy(RNG.normal(size=(4, 5)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(5, 6)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    pol = ContractionPolicy.of(ffn="square_virtual",
                               **{"ffn.bwd_w": "standard"})
    with counting.track_contractions() as ctr:
        torch.sum(fs_einsum("tk,kn->tn", x, w, policy=pol,
                            site="ffn")).backward()
    modes = {r.site: r.mode for r in ctr.records}
    assert modes == {"ffn": "square_virtual", "ffn.bwd_x": "square_virtual",
                     "ffn.bwd_w": "standard"}
    assert ctr.bwd_mults == 2 * 4 * 5 * 6
    assert 0.0 < ctr.fraction_square_bwd < 1.0


def test_serving_and_integer_calls_skip_the_vjp():
    """No grad mode, no operand requiring grad, or integer operands: the
    plain dispatch, with no backward site and no autograd node."""
    x = torch.ones(3, 4, requires_grad=True)
    w = torch.ones(4, 2)
    with torch.no_grad():
        assert fs_einsum("mk,kn->mn", x, w, mode="square_virtual").grad_fn \
            is None
    assert fs_einsum("mk,kn->mn", x.detach(), w,
                     mode="square_virtual").grad_fn is None
    xi = torch.ones(3, 4, dtype=torch.int8)
    out = fs_einsum("mk,kn->mn", xi, w.to(torch.int8), mode="square_exact")
    assert out.dtype == torch.int32 and out.grad_fn is None


def test_vjp_escape_hatch(monkeypatch):
    """``$REPRO_EINSUM_VJP=0``: the torch-level modes differentiate
    mechanically (grads right, no ``.bwd_*`` site); ``square_pallas``
    raises rather than returning a missing or zero gradient."""
    monkeypatch.setenv("REPRO_EINSUM_VJP", "0")
    assert not vjp_enabled()
    x = RNG.normal(size=(4, 5)).astype(np.float32)
    w = RNG.normal(size=(5, 6)).astype(np.float32)
    rx, rw = jax.grad(lambda x, w: jnp.sum(jnp.einsum("tk,kn->tn", x, w)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for mode in ("square_virtual", "square_exact", "square_scan"):
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        with counting.track_contractions() as ctr:
            dx, dw = torch.autograd.grad(torch.sum(fs_einsum(
                "tk,kn->tn", tx, tw, mode=mode, site="ffn")), (tx, tw))
        np.testing.assert_allclose(dx.numpy(), np.asarray(rx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), np.asarray(rw), rtol=1e-5,
                                   atol=1e-5)
        assert not any(".bwd_" in s for s in ctr.by_site())
        assert ctr.bwd_mults == 0
    tx = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="REPRO_EINSUM_VJP"):
        fs_einsum("tk,kn->tn", tx, torch.from_numpy(w), mode="square_pallas",
                  site="ffn")
    # without grad the kernel mode serves as before
    with torch.no_grad():
        out = fs_einsum("tk,kn->tn", tx, torch.from_numpy(w),
                        mode="square_pallas")
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_guard_trip_in_backward_demotes_only_the_backward_site():
    """A backward contraction whose square route saturates (cotangent
    ~1e22, so ``(g+w)^2`` is inf in f32) under an enabled guard completes
    on the standard route: the gradient finite and equal to JAX's, the
    demotion on ``chaos.bwd_*`` only, the forward site untouched."""
    x = RNG.normal(size=(8, 16)).astype(np.float32)
    w = RNG.normal(size=(16, 4)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    with guards.guarded(trip_limit=1):
        with counting.track_contractions() as ctr:
            loss = torch.sum(fs_einsum("mk,kn->mn", tx, torch.from_numpy(w),
                                       mode="square_exact",
                                       site="chaos")) * 1e22
            dx, = torch.autograd.grad(loss, tx)
    assert bool(torch.isfinite(dx).all())
    ref = jax.grad(lambda x: jnp.sum(jnp.einsum("mk,kn->mn", x,
                                                jnp.asarray(w))) * 1e22)(
        jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref), rtol=1e-5)
    demoted = ctr.demoted_sites()
    assert demoted and all(s.startswith("chaos.bwd_") for s in demoted)
    modes = {r.site: (r.mode, r.demoted) for r in ctr.records}
    assert modes["chaos"] == ("square_exact", False)
    # the next run at sane magnitudes, after a reset, serves square again
    routing.reset_route_health()
    tx = torch.from_numpy(x).requires_grad_(True)
    with guards.guarded(trip_limit=1):
        with counting.track_contractions() as ctr:
            torch.sum(fs_einsum("mk,kn->mn", tx, torch.from_numpy(w),
                                mode="square_virtual", site="chaos")
                      ).backward()
    assert ctr.demoted_sites() == [] and ctr.fraction_square == 1.0


def _random_case(rng):
    """A random (batched / transposed-y / summed-out) contraction, as
    ``tests/test_vjp_square.py::_random_matmul_case`` draws them."""
    b = int(rng.integers(0, 3))
    m, k, n = (int(rng.integers(1, 7)) for _ in range(3))
    bdims = "ZY"[:b]
    bshape = tuple(int(rng.integers(1, 4)) for _ in bdims)
    transpose_y = bool(rng.integers(0, 2)) and b == 0
    x_extra = bool(rng.integers(0, 2))
    xs = bdims + "mk" + ("s" if x_extra else "")
    ys = "nk" if transpose_y else bdims + "kn"
    spec = f"{xs},{ys}->{bdims}mn"
    x_shape = bshape + (m, k) + ((2,) if x_extra else ())
    y_shape = (n, k) if transpose_y else bshape + (k, n)
    return spec, x_shape, y_shape


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mode", ["square_virtual", "square_exact",
                                  "square_pallas"])
def test_random_contractions(seed, mode):
    """Seeded sweep over summed-out, transposed and batched contractions
    (``_unreduce`` and the summed-out backward paths)."""
    spec, xs, ys = _random_case(np.random.default_rng(2000 + seed))
    x, y, cot = _operands(spec, xs, ys)
    dx, dy = _torch_grads(spec, torch.from_numpy(x), torch.from_numpy(y),
                          cot, mode=mode)
    rx, ry = _jax_grads(spec, jnp.asarray(x), jnp.asarray(y), cot)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rx), rtol=1e-5,
                               atol=1e-5, err_msg=spec)
    np.testing.assert_allclose(dy.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5, err_msg=spec)


def _rel64(got, exact):
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - exact) / np.linalg.norm(exact))


@pytest.mark.parametrize("mode", ["square_scan", "square_pallas"])
def test_dynamic_range_gap_matches_jax(mode, monkeypatch):
    """A projection's backward at full width's magnitudes: 2048 tokens of
    activations ~N(0, 5^2) and cotangents ~N(0, 1e-8), weights ~0.02.  The
    square form's f32 error, ~2^-24 * (|a| + |b|)^2 a term, dwarfs the
    product |ab| there, so dL/dW is ~20 % off the exact product.  The port
    must be off by as much as the JAX package is in the same mode (its
    Pallas kernel runs in interpret mode), within 2x either way, not by
    more; and with the cotangent scaled by 2^11 (exact) both gaps close to
    below 1e-3."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2048, 256)) * 5.0).astype(np.float32)
    w = (rng.normal(size=(256, 256)) * 0.02).astype(np.float32)
    g0 = (rng.normal(size=(2048, 256)) * 1e-4).astype(np.float32)
    for scale in (1.0, 2.0 ** 11):
        g = g0 * np.float32(scale)
        ex = g.astype(np.float64) @ w.astype(np.float64).T
        ew = x.astype(np.float64).T @ g.astype(np.float64)
        _, vjp = jax.vjp(lambda a, b: jeinsum("mk,kn->mn", a, b, mode=mode,
                                              site="ffn"),
                         jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        dx, dw = torch.autograd.grad(
            fs_einsum("mk,kn->mn", tx, tw, mode=mode, site="ffn"),
            (tx, tw), torch.from_numpy(g))
        gaps = {"dx": (_rel64(dx.numpy(), ex), _rel64(jdx, ex)),
                "dW": (_rel64(dw.numpy(), ew), _rel64(jdw, ew))}
        print(f"{mode} cotangent x {scale:g}: ||grad - exact|| / ||exact|| "
              + ", ".join(f"{k} port {p:.3e} JAX {j:.3e}"
                          for k, (p, j) in gaps.items()))
        for port, ref in gaps.values():
            assert 0.5 * ref <= port <= 2.0 * ref
        if scale == 1.0:
            assert min(gaps["dW"]) > 5e-2          # the gap reproduces
        else:
            assert max(max(v) for v in gaps.values()) < 1e-3
