"""Public wrappers around the square kernels: the PyTorch port of
``repro/kernels/ops.py``.

The prep is split into the paper's weight-stationary halves:
:func:`prepare_matmul_rhs` widens the column operand and computes ``Sb``,
and :func:`prepare_conv2d_weights` lays out the widened filters and
computes ``Sw`` (the work a
:class:`~repro_torch.core.prepared.PreparedOperand` keeps).  The execute
halves widen the activation and launch the kernel: K1, or K2/K3 for a
batched GEMM; K7 for the fused conv, or im2col patches through K1.  Raw
and prepared calls share these functions, so they are bit-identical.  The
complex matmuls split their operands into planes, compute the paper's
corrections and launch K5 (CPM3) or K6 (CPM4).

Each launch takes its variant (K1's tile, K2/K3's rows and columns, K4's
splits, K5/K6's thread tile, K7's band and splits) from the port's planner,
:mod:`repro_torch.kernels.tuning`: an explicit plan, the autotune cache or
the model rule, in that order, resolved inside each kernel's wrapper at its
launch.  The JAX package's Pallas tile fields (``bm``/``bn``/``bk``/``kc``,
``_pick_fb``) and its ``_pad_operands`` have no counterpart: each CUDA
kernel masks its ragged edges, so nothing is padded on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import conv as conv_core
from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand
from repro_torch.device import Device, operand_device, resolve_device
from repro_torch.kernels import routing
from repro_torch.kernels.cpm3_matmul import cpm3_matmul_k5
from repro_torch.kernels.cpm4_matmul import cpm4_matmul_k6
from repro_torch.kernels.sq_conv import sq_conv_k8
from repro_torch.kernels.sq_conv2d import conv2d_out_hw, sq_conv2d_k7
from repro_torch.kernels.sq_matmul import (sq_matmul_k1, sq_matmul_k2,
                                           sq_matmul_k3)

__all__ = ["sq_matmul", "sq_matmul_local", "prepare_matmul_rhs",
           "cpm3_matmul", "cpm4_matmul", "cpm3_corrections",
           "cpm4_corrections", "sq_conv", "sq_conv2d",
           "sq_conv2d_im2col", "sq_conv2d_routed", "prepare_conv2d_weights"]


def prepare_matmul_rhs(b: torch.Tensor, acc: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-operand half: ``b`` (k, n) or (B, k, n) widened to the
    accumulator dtype ``acc`` (default: ``b``'s own), contiguous, and its
    correction ``Sb`` (n,) or (B, n)."""
    bw = b.to(acc or sq.accum_dtype(b.dtype)).contiguous()
    return bw, sq.col_correction(bw, dim=-2)


def _sq_matmul_exec(a: torch.Tensor, bw: torch.Tensor,
                    sb: torch.Tensor) -> torch.Tensor:
    """The execute half: stream the (m, k) activation against a prepared
    column operand through K1."""
    aw = a.to(bw.dtype).contiguous()
    return sq_matmul_k1(aw, bw, sq.row_correction(aw, dim=-1), sb)


def _sq_matmul_batched_exec(a: torch.Tensor, bw: torch.Tensor,
                            sb: torch.Tensor, fold: bool) -> torch.Tensor:
    """The execute half of a batched GEMM: widen the (B, m, k) activation,
    compute ``Sa`` (B, m) and run K3 (``fold``) or K2 against the prepared
    ``(bw, sb)``.

    The JAX package's fold width (``_pick_fb``, ``FOLD_ROW_TARGET``) and its
    zero batch padding are Pallas tiling.  Here the number of elements a
    block folds is K3's own launch geometry, and a ragged batch, m, n and k
    are masked inside both kernels, so nothing is padded on the host."""
    aw = a.to(bw.dtype).contiguous()
    kernel = sq_matmul_k3 if fold else sq_matmul_k2
    return kernel(aw, bw, sq.row_correction(aw, dim=-1), sb)


def _check_batched_shapes(a: torch.Tensor, b_shape) -> None:
    if a.ndim != 3 or a.shape[0] != b_shape[0] or a.shape[2] != b_shape[1]:
        raise ValueError(f"batched contraction mismatch: "
                         f"{tuple(a.shape)} @ {tuple(b_shape)}")


def sq_matmul_local(a: torch.Tensor,
                    b: Union[torch.Tensor, PreparedOperand], *,
                    fold: bool = False) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` through K1, or ``a[B, M, K] @ b[B, K, N]``
    through K2 (K3 with ``fold``), on the device ``a`` lies on.

    Against a 2D ``b``, leading dims of ``a`` collapse to rows (the
    dense-layer convention).  A batched ``b`` may be a ``matmul_batched``
    PreparedOperand: its ``canon``/``corr`` are streamed as they are, which
    is what a raw ``b`` is prepared into per call.  Returns the
    accumulator dtype (f32 for floats, int32 for small ints).
    """
    if isinstance(b, PreparedOperand) and b.kind == "matmul_batched":
        _check_batched_shapes(a, (b.canon.shape[0],) + b.kn_shape)
        acc = sq.accum_dtype(a.dtype)
        if b.canon.dtype == acc:
            return _sq_matmul_batched_exec(a, b.canon, b.corr, fold)
        return _sq_matmul_batched_exec(
            a, *prepare_matmul_rhs(b.kn_source(), acc), fold)
    if isinstance(b, PreparedOperand):
        if b.kind != "matmul":
            raise ValueError(f"sq_matmul got a {b.kind!r} PreparedOperand")
        k, n = b.kn_shape
    elif b.ndim == 3:
        _check_batched_shapes(a, tuple(b.shape))
        return _sq_matmul_batched_exec(
            a, *prepare_matmul_rhs(b, sq.accum_dtype(a.dtype)), fold)
    else:
        if b.ndim != 2:
            raise ValueError(f"rhs must be 2D (K, N) or batched 3D "
                             f"(B, K, N), got {tuple(b.shape)}")
        k, n = b.shape
    if a.shape[-1] != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"({k}, {n})")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k)
    acc = sq.accum_dtype(a.dtype)
    if isinstance(b, PreparedOperand) and b.canon.dtype == acc:
        out = _sq_matmul_exec(a2, b.canon, b.corr)
    else:
        src = b.kn_source() if isinstance(b, PreparedOperand) else b
        out = _sq_matmul_exec(a2, *prepare_matmul_rhs(src, acc))
    return out.reshape(*lead, n)


def sq_matmul(a, b, *, fold: bool = False,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """Square-based matmul through K1, or K2/K3 (public entry point).

    ``a`` (m, k) @ ``b`` (k, n) runs K1; ``a`` (B, m, k) @ ``b`` (B, k, n)
    runs K2, or K3 with ``fold=True`` (the small-(m, n), large-B route of
    :mod:`repro_torch.kernels.routing`).  Runs on ``device`` (default:
    CUDA, which must be present); a CPU device runs the kernels' plain
    version.  ``b`` may be a PreparedOperand (2D, or batched for K2/K3),
    which must already lie on that device.

    >>> a = torch.arange(6.0).reshape(2, 3)
    >>> b = torch.ones(3, 4)
    >>> torch.allclose(sq_matmul(a, b, device="cpu"), a @ b)
    True
    >>> ai = torch.tensor([[3, -7]], dtype=torch.int8)
    >>> bi = torch.tensor([[5], [2]], dtype=torch.int8)
    >>> int(sq_matmul(ai, bi, device="cpu")[0, 0])      # int8: bit-exact
    1
    >>> a3, b3 = torch.ones(4, 2, 3), torch.ones(4, 3, 5)
    >>> tuple(sq_matmul(a3, b3, fold=True, device="cpu").shape)
    (4, 2, 5)
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dev)
    if isinstance(b, PreparedOperand):
        if b.device != a.device:
            raise ValueError(f"prepared operand lies on {b.device}, the "
                             f"call runs on {a.device}")
    else:
        b = torch.as_tensor(b).to(dev)
    return sq_matmul_local(a, b, fold=fold)


# --------------------------------------------------------------------------
# Complex square-based matmuls (CPM3 / CPM4)
# --------------------------------------------------------------------------

def _operand_planes(x, dev: torch.device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The (re, im) planes of a 2D operand on ``dev``; a real operand's
    imaginary plane is zeros (as ``jnp.imag`` gives).  complex128 and
    float64 come down to complex64 and float32, as ``jnp.asarray`` brings
    them with x64 off."""
    t = torch.as_tensor(x).to(dev)
    if t.dtype == torch.complex128:
        t = t.to(torch.complex64)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    if t.ndim != 2:
        raise ValueError(f"complex matmul operands are 2D, got "
                         f"{tuple(t.shape)}")
    if t.is_complex():
        return t.real, t.imag
    return t, torch.zeros_like(t)


def _complex_operands(x, y, device: Device):
    """Both operands as four contiguous planes (a, b, c, s) in the
    accumulator dtype: ``torch.Tensor.real``/``.imag`` are strided views,
    and the kernels take contiguous planes."""
    dev = operand_device(x, device)
    a, b = _operand_planes(x, dev)
    c, s = _operand_planes(y, dev)
    if a.shape[1] != c.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(c.shape)}")
    acc = sq.accum_dtype(a.dtype)
    return tuple(t.to(acc).contiguous() for t in (a, b, c, s))


def cpm3_matmul(x, y, *, device: Device = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex matmul with 3 squares per multiply through K5.

    ``x`` (m, k) @ ``y`` (k, n), complex tensors or arrays (a real operand
    has an imaginary plane of zeros); returns the (re, im) f32 planes.
    Integer operands raise ``TypeError``, as the Pallas kernel cannot take
    them: the exact integer path is :mod:`repro_torch.core.complexmm`.

    >>> x = torch.tensor([[1 + 2j, 3 - 1j]])
    >>> y = torch.tensor([[2 - 1j], [1j]])
    >>> re, im = cpm3_matmul(x, y, device="cpu")
    >>> complex(re[0, 0], im[0, 0]) == complex((x @ y)[0, 0])
    True
    """
    a, b, c, s = _complex_operands(x, y, device)
    return cpm3_matmul_k5(a, b, c, s, *cpm3_corrections(a, b, c, s))


def cpm3_corrections(a, b, c, s):
    """K5's corrections of the planes (paper eqs 33 / 35): ``Sab``,
    ``Sba`` (m,) and ``Scs``, ``Ssc`` (n,)."""
    return (sq.acc_sum(-sq.square(a + b) + sq.square(b), -1),
            sq.acc_sum(-sq.square(a + b) - sq.square(a), -1),
            sq.acc_sum(-sq.square(c) + sq.square(c + s), 0),
            sq.acc_sum(-sq.square(c) - sq.square(s - c), 0))


def cpm4_corrections(a, b, c, s):
    """K6's shared corrections of the planes (paper eq 18): ``Sx`` (m,)
    and ``Sy`` (n,)."""
    return (-sq.acc_sum(sq.square(a) + sq.square(b), -1),
            -sq.acc_sum(sq.square(c) + sq.square(s), 0))


def cpm4_matmul(x, y, *, device: Device = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex matmul with 4 squares per multiply through K6; operands and
    result as :func:`cpm3_matmul`."""
    a, b, c, s = _complex_operands(x, y, device)
    return cpm4_matmul_k6(a, b, c, s, *cpm4_corrections(a, b, c, s))


# --------------------------------------------------------------------------
# Square-based convolutions
# --------------------------------------------------------------------------

def sq_conv(x, w, *, device: Device = None) -> torch.Tensor:
    """Square-based valid 1D correlation ``y_k = sum_i w_i x_{i+k}`` through
    K8.  ``x`` (L,) samples, ``w`` (n,) taps, 1 <= n <= L; returns (L-n+1,)
    in the accumulator dtype (int8 operands give an exact int32 result).

    >>> x = torch.arange(8.0)
    >>> sq_conv(x, torch.tensor([1.0, -1.0]), device="cpu")
    tensor([-1., -1., -1., -1., -1., -1., -1.])
    """
    dev = operand_device(x, device)
    x, w = torch.as_tensor(x).to(dev), torch.as_tensor(w).to(dev)
    if x.ndim != 1 or w.ndim != 1:
        raise ValueError(f"sq_conv takes 1D samples and taps, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    acc = sq.accum_dtype(x.dtype)
    xw, ww = x.to(acc).contiguous(), w.to(acc).contiguous()
    sw = sq.col_correction(ww, dim=0).reshape(1)              # -sum w^2
    return sq_conv_k8(xw, ww, sw)


def prepare_conv2d_weights(w4: torch.Tensor,
                           acc: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The filter half of the conv2d prep.

    ``w4`` (cout, cin, kh, kw) widened to ``acc`` (default: its own
    accumulator dtype).  Returns ``(wt, sw, wmat)``: K7's tap matrix
    ``(kh*kw*cin, cout)`` (K ordered (kh, kw, cin), the Pallas kernel's
    ``(kh, kw, Cp, Np)`` tap block), the per-filter correction ``Sw``
    (cout,), and the im2col route's ``(cin*kh*kw, cout)`` filter matrix,
    whose column correction is that same ``Sw``.
    """
    ww = w4.to(acc or sq.accum_dtype(w4.dtype))
    cout = ww.shape[0]
    wmat = ww.reshape(cout, -1).T.contiguous()               # (K, cout)
    sw = sq.col_correction(wmat, dim=0)                      # (cout,)
    wt = ww.permute(2, 3, 1, 0).reshape(-1, cout).contiguous()
    return wt, sw, wmat


def _conv2d_geometry(x4_shape, w4_shape, stride, padding):
    """Resolve stride/padding and the output extents for rank-4 operands."""
    strides = conv_core.resolve_stride(stride)
    pads = conv_core.resolve_padding(padding, x4_shape[2:], w4_shape[2:],
                                     strides)
    oh, ow = conv2d_out_hw(x4_shape[2:], w4_shape[2:], strides, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"kernel {tuple(w4_shape[2:])} larger than padded "
                         f"input {tuple(x4_shape[2:])} under pads {pads}")
    return strides, pads, (oh, ow)


def _normalize_conv_operands(x, w, device: Device):
    """Place the operands on the call's device and normalize them to rank 4:
    returns ``(x4, w4, prep, kind)``, ``prep`` the conv2d PreparedOperand
    or None.  A prepared operand must already lie on the call's device."""
    dev = operand_device(x, device)
    x = torch.as_tensor(x).to(dev)
    prep = w if isinstance(w, PreparedOperand) else None
    if prep is not None:
        if prep.kind != "conv2d":
            raise ValueError(f"conv2d got a {prep.kind!r} PreparedOperand; "
                             f"expected a conv2d one")
        if prep.device != dev:
            raise ValueError(f"prepared operand lies on {prep.device}, the "
                             f"call runs on {dev}")
        w = prep.source
    else:
        w = torch.as_tensor(w).to(dev)
    x4, w4, kind = conv_core.normalize_conv2d(x, w)
    return x4, w4, prep, kind


def _conv2d_weights(w4, prep, acc):
    """The prepared filter half, or the same prep run now on raw filters
    (also when the prepared dtype is not the call's accumulator dtype)."""
    if prep is not None and prep.canon.dtype == acc:
        return prep.canon, prep.corr, prep.im2col
    return prepare_conv2d_weights(w4, acc)


def sq_conv2d(x, w, *, stride=1, padding="VALID",
              device: Device = None) -> torch.Tensor:
    """Square-based 2D correlation through the FUSED kernel K7 (no im2col
    patch tensor, no padded copy of the input).

    x: (B, cin, H, W) -- or (cin, H, W), or (H, W) with rank-2/3 filters
    (:func:`repro_torch.core.conv.normalize_conv2d`); w: (cout, cin, kh,
    kw), or a conv2d PreparedOperand.  ``stride`` is an int or (sh, sv);
    ``padding`` is "VALID", "SAME", an int, or explicit (lo, hi) pairs.
    Returns the accumulator dtype (f32 for floats, int32 for small ints).

    >>> x = torch.arange(36.0).reshape(6, 6)
    >>> out = sq_conv2d(x, torch.ones(3, 3), device="cpu")
    >>> tuple(out.shape), bool(out[0, 0] == x[:3, :3].sum())
    ((4, 4), True)
    """
    x4, w4, prep, kind = _normalize_conv_operands(x, w, device)
    strides, pads, _ = _conv2d_geometry(x4.shape, w4.shape, stride,
                                        padding)
    acc = sq.accum_dtype(x4.dtype)
    wt, sw, _ = _conv2d_weights(w4, prep, acc)
    out = sq_conv2d_k7(x4.to(acc).contiguous(), wt, sw,
                       khw=tuple(w4.shape[2:]), stride=strides, pads=pads)
    return conv_core.denormalize_conv2d(out, kind)


def _im2col_patches(xw: torch.Tensor, khw, strides, pads, ohw):
    """(B, cin, H, W) -> the (B*oh*ow, cin*kh*kw) patch matrix of the padded
    input, K ordered (cin, kh, kw) to match the im2col filter matrix."""
    kh, kw = khw
    sh, sv = strides
    oh, ow = ohw
    (ph0, ph1), (pw0, pw1) = pads
    xp = F.pad(xw, (pw0, pw1, ph0, ph1))
    taps = [xp[:, :, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sv + 1:sv]
            for i in range(kh) for j in range(kw)]
    patches = torch.stack(taps, dim=-1)          # (B, cin, oh, ow, kh*kw)
    B, C = xw.shape[:2]
    return patches.permute(0, 2, 3, 1, 4).reshape(B * oh * ow, C * kh * kw)


def sq_conv2d_im2col(x, w, *, stride=1, padding="VALID",
                     device: Device = None) -> torch.Tensor:
    """Square-based 2D correlation through im2col + K1 (conv2d mode
    ``square_exact``, and the planner's route at tiny K volumes).

    The windows are materialised as a (B*oh*ow, cin*kh*kw) patch matrix
    (each input pixel copied once per covering tap) that streams through
    K1 against the prepared (cin*kh*kw, cout) filter matrix.  Accepts the
    operands, stride and padding of :func:`sq_conv2d`.
    """
    x4, w4, prep, kind = _normalize_conv_operands(x, w, device)
    strides, pads, ohw = _conv2d_geometry(x4.shape, w4.shape, stride,
                                          padding)
    acc = sq.accum_dtype(x4.dtype)
    _, sw, wmat = _conv2d_weights(w4, prep, acc)
    pmat = _im2col_patches(x4.to(acc), tuple(w4.shape[2:]), strides, pads,
                           ohw)
    out = _sq_matmul_exec(pmat, wmat, sw)          # (B*oh*ow, cout)
    B, cout = x4.shape[0], wmat.shape[1]
    out = out.reshape(B, *ohw, cout).permute(0, 3, 1, 2).contiguous()
    return conv_core.denormalize_conv2d(out, kind)


def sq_conv2d_routed(x, w, *, stride=1, padding="VALID",
                     device: Device = None) -> torch.Tensor:
    """The planner-routed conv (conv2d mode ``square_pallas``): resolves the
    geometry once, asks :func:`repro_torch.kernels.routing.
    select_conv2d_route` for the route and runs :func:`sq_conv2d` (fused,
    K7) or :func:`sq_conv2d_im2col`.  ``w`` may be a conv2d
    PreparedOperand."""
    dev = operand_device(x, device)
    x = torch.as_tensor(x).to(dev)
    x4, w4, _, _ = _normalize_conv_operands(x, w, dev)
    _, _, (oh, ow) = _conv2d_geometry(x4.shape, w4.shape, stride, padding)
    cout, cin, kh, kw = w4.shape
    route = routing.select_conv2d_route(oh, ow, kh, kw, cin, cout,
                                        batch=x4.shape[0], dtype=x4.dtype)
    f = sq_conv2d if route.name == "fused" else sq_conv2d_im2col
    return f(x, w, stride=stride, padding=padding, device=dev)
