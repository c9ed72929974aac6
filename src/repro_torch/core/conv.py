"""Square-based convolutions and correlations (paper §5, §5.1, §8, §11):
the PyTorch port of ``repro/core/conv.py``.

Real 1D correlation (paper eq 10/11):

    y_k = sum_i w_i x_{i+k} = 1/2 ( sum_i (w_i + x_{i+k})^2 + Sx_k + Sw )
    Sx_k = -sum_i x_{i+k}^2   (sliding sum of squares, the shared x^2 term)
    Sw   = -sum_i w_i^2       (precomputed: the weights are constant)

Real 2D correlation (paper §5.1, eqs 12-14) is the same form over an
(Mk, Nk) window, and :func:`conv2d` is its multi-channel batched form at
CNN-layer scale.

Modes of the 1D/2D correlations: ``standard`` (the multiplier baseline),
``square`` (every window's squares materialised, test scale) and
``square_virtual`` (the multiplier with the x2 carry and final halving).
:func:`conv2d` has the four modes of :data:`CONV2D_MODES`; its
``square_pallas`` mode runs the hand-written kernels (K7, or im2col
patches through K1) chosen by
:func:`repro_torch.kernels.routing.select_conv2d_route`.

Layouts are the JAX package's: NCHW inputs, OIHW filters, the same rank
shorthands and the same output layout tags.  Integer operands (int8/int16)
accumulate in int32 in the square modes, so those are exact.  Every public
function takes ``device``: tensors stay on their own device unless one is
named, and arrays go to CUDA unless the caller names another device.

:func:`complex_correlate1d` is the complex 1D correlation in the CPM4
(paper §8) and CPM3 (paper §11) forms, and :func:`iir_filter` an IIR filter
whose feedback products are squares (paper §5).  Both compute in broadcast
form, at test scale, and launch no kernel, as in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import squares as sq
from repro_torch.core.complexmm import join_planes, split_planes
from repro_torch.device import Device, operand_device

__all__ = ["correlate1d", "convolve1d", "correlate2d", "conv2d",
           "complex_correlate1d", "iir_filter", "sliding_sum_squares",
           "filters4", "normalize_conv2d",
           "denormalize_conv2d", "resolve_stride", "resolve_padding",
           "CONV2D_MODES"]

CONV2D_MODES = ("standard", "square_virtual", "square_exact",
                "square_pallas")


def _place(x, w, device: Device) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = operand_device(x, device)
    return torch.as_tensor(x).to(dev), torch.as_tensor(w).to(dev)


@contextlib.contextmanager
def _full_f32():
    """cuDNN runs f32 convolutions in TF32 by default; the multiplier
    baseline stays full f32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(fn, x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
          **kw) -> torch.Tensor:
    """``fn`` (``F.conv1d``/``F.conv2d``) of ``x`` and ``w`` computed in
    ``dtype``.  Integer dtypes run in float64, exact while every partial sum
    stays below 2**53, and wrap to ``dtype`` like an integer conv."""
    with _full_f32():
        if dtype.is_floating_point:
            return fn(x.to(dtype), w.to(dtype), **kw)
        out = fn(x.double(), w.double(), **kw)
    return out.round().to(torch.int64).to(dtype)


def sliding_sum_squares(x, n: int, *, device: Device = None) -> torch.Tensor:
    """``sum_i x_{i+k}^2`` for every window position k (the shared x^2
    term), from one running sum of squares over the stream."""
    x = torch.as_tensor(x).to(operand_device(x, device))
    xs = sq.square(x)
    c = torch.cumsum(xs, dim=-1, dtype=xs.dtype)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., n:] - c[..., :-n]


def _sum(t: torch.Tensor, dim) -> torch.Tensor:
    return torch.sum(t, dim=dim, dtype=t.dtype)


def correlate1d(x, w, *, mode: str = "standard",
                device: Device = None) -> torch.Tensor:
    """Valid 1D correlation ``y_k = sum_i w_i x_{i+k}`` (paper eq 10)."""
    x, w = _place(x, w, device)
    n = w.shape[-1]
    if mode == "standard":
        dt = torch.promote_types(x.dtype, w.dtype)
        return _conv(F.conv1d, x[None, None], w[None, None], dt)[0, 0]
    acc = sq.accum_dtype(x.dtype)
    xw, ww = x.to(acc), w.to(acc)
    if mode == "square":
        win = xw.unfold(-1, n, 1)                           # (K, n)
        sab = _sum(sq.pm(win, ww), -1)                      # sum (w+x)^2
        sxk = -sliding_sum_squares(xw, n)                   # shared x^2 term
        sw = -_sum(sq.square(ww), -1)                       # precomputable
        return sq.halve(sab + sxk + sw)
    if mode == "square_virtual":
        y = correlate1d(x, w, mode="standard").to(acc)
        return sq.halve(y + y)                              # x2 carry + shift
    raise ValueError(f"unknown conv mode {mode!r}")


def convolve1d(x, w, *, mode: str = "standard",
               device: Device = None) -> torch.Tensor:
    """Valid 1D convolution: the correlation with the flipped kernel."""
    x, w = _place(x, w, device)
    return correlate1d(x, w.flip(-1), mode=mode)


def correlate2d(x, w, *, mode: str = "standard",
                device: Device = None) -> torch.Tensor:
    """Valid 2D correlation (paper §5.1 eq 12) of an (H, W) plane."""
    x, w = _place(x, w, device)
    mk, nk = w.shape
    if mode == "standard":
        dt = torch.promote_types(x.dtype, w.dtype)
        return _conv(F.conv2d, x[None, None], w[None, None], dt)[0, 0]
    acc = sq.accum_dtype(x.dtype)
    xw, ww = x.to(acc), w.to(acc)
    if mode == "square":
        win = xw.unfold(0, mk, 1).unfold(1, nk, 1)          # (oh, ow, mk, nk)
        sab = _sum(sq.pm(win, ww), (-2, -1))                # eq 14 Swx
        sx = -_sum(sq.square(win), (-2, -1))                # eq 14 Sx
        sw = -_sum(sq.square(ww), (-2, -1))                 # eq 14 Sw
        return sq.halve(sab + sx + sw)
    if mode == "square_virtual":
        y = correlate2d(x, w, mode="standard").to(acc)
        return sq.halve(y + y)
    raise ValueError(f"unknown conv mode {mode!r}")


# --------------------------------------------------------------------------
# Multi-channel batched 2D convolution (paper §5.1 at CNN-layer scale).
# --------------------------------------------------------------------------

def resolve_stride(stride) -> Tuple[int, int]:
    """Normalize a stride spec to (sh, sv)."""
    if isinstance(stride, int):
        return (stride, stride)
    sh, sv = stride
    return (int(sh), int(sv))


def resolve_padding(padding, hw, khw, stride) -> Tuple[Tuple[int, int],
                                                        Tuple[int, int]]:
    """Normalize a padding spec to explicit ((ph0, ph1), (pw0, pw1)).

    Accepts "VALID", "SAME" (XLA's rule: output extent ceil(in/stride),
    the odd pixel of padding going after), a single int, or explicit
    per-axis (lo, hi) pairs.
    """
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            pads = []
            for size, k, s in zip(hw, khw, stride):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads.append((total // 2, total - total // 2))
            return tuple(pads)
        raise ValueError(f"unknown padding {padding!r}; expected 'VALID', "
                         f"'SAME', an int, or ((lo, hi), (lo, hi))")
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    (a, b), (c, d) = padding
    return ((int(a), int(b)), (int(c), int(d)))


def filters4(w: torch.Tensor) -> torch.Tensor:
    """The (cout, cin, kh, kw) view of a filter bank or its rank shorthand:
    (kh, kw) is one single-channel filter, (cout, kh, kw) a single-channel
    bank."""
    if w.ndim == 2:
        return w[None, None]
    if w.ndim == 3:
        return w[:, None]
    if w.ndim == 4:
        return w
    raise ValueError(f"conv2d filters must be rank 2-4, got "
                     f"{tuple(w.shape)}")


def normalize_conv2d(x: torch.Tensor, w: torch.Tensor):
    """Normalize conv2d operands to x (B, cin, H, W) / w (cout, cin, kh, kw).

    Rank shorthands: x (H, W) or (cin, H, W); w (kh, kw) -- one filter,
    cin 1 -- or (cout, kh, kw) -- a single-channel filter bank.  Returns
    the rank-4 operands plus the output layout tag consumed by
    :func:`denormalize_conv2d` ("hw" / "chw" / "nchw").
    """
    w4 = filters4(w)
    if x.ndim == 2:
        x4 = x[None, None]
    elif x.ndim == 3:
        x4 = x[None]
    elif x.ndim == 4:
        x4 = x
    else:
        raise ValueError(f"conv2d input must be rank 2-4, got "
                         f"{tuple(x.shape)}")
    if x4.shape[1] != w4.shape[1]:
        raise ValueError(f"channel mismatch: input has {x4.shape[1]} "
                         f"channels, filters expect {w4.shape[1]} "
                         f"({tuple(x.shape)} vs {tuple(w.shape)})")
    # The output layout follows the INPUT rank first (a batched input never
    # loses its batch axis to a filter-rank shorthand), then the filter rank
    # decides whether the cout axis is kept.
    if x.ndim == 4:
        kind = "nchw"
    elif w.ndim == 2:
        kind = "hw"
    else:
        kind = "chw"
    return x4, w4, kind


def denormalize_conv2d(out: torch.Tensor, kind: str) -> torch.Tensor:
    """Undo :func:`normalize_conv2d` on a (B, cout, oh, ow) result."""
    if kind == "hw":
        return out[0, 0]
    if kind == "chw":
        return out[0]
    return out


def conv2d_nchw(x4: torch.Tensor, w4: torch.Tensor, strides, pads,
                dtype: torch.dtype) -> torch.Tensor:
    """The multiplier conv of rank-4 operands with explicit (asymmetric)
    padding, computed in ``dtype`` (full f32 on the card)."""
    (ph0, ph1), (pw0, pw1) = pads
    xp = F.pad(x4, (pw0, pw1, ph0, ph1))
    return _conv(F.conv2d, xp, w4, dtype, stride=strides)


def conv2d(x, w, *, stride=1, padding="VALID", mode: str = "standard",
           device: Device = None) -> torch.Tensor:
    """Multi-channel batched 2D correlation with fair-square mode dispatch.

    x: (B, cin, H, W) (or the rank shorthands of :func:`normalize_conv2d`);
    w: (cout, cin, kh, kw), or a conv2d
    :class:`~repro_torch.core.prepared.PreparedOperand`
    (``prepare_operand(w, for_="conv2d")``), bit-identical to the raw
    filters.  Modes:

    ``standard``
        ``F.conv2d`` in the operands' dtype, full f32 on the card.
    ``square_virtual``
        The multiplier conv accumulated at the accumulator dtype (int8 in
        int32, bf16 in f32), then the x2 carry and the final halving.
    ``square_exact``
        The materialised im2col route: patches through K1
        (:func:`repro_torch.kernels.ops.sq_conv2d_im2col`).
    ``square_pallas``
        The routed kernel path: the fused K7 (no patch tensor) where the
        window reuse pays, the im2col route at tiny K volumes whose patch
        matrix stays cache-resident
        (:func:`repro_torch.kernels.routing.select_conv2d_route`;
        ``REPRO_ROUTE`` pins it).

    >>> x = torch.arange(36.0).reshape(6, 6)
    >>> out = conv2d(x, torch.ones(3, 3), mode="square_pallas",
    ...              device="cpu")                  # squares only
    >>> tuple(out.shape), bool(out[0, 0] == x[:3, :3].sum())
    ((4, 4), True)
    """
    from repro_torch.core.prepared import PreparedOperand
    if mode not in CONV2D_MODES:
        raise ValueError(f"unknown conv2d mode {mode!r}; expected one of "
                         f"{CONV2D_MODES}")
    if mode in ("square_exact", "square_pallas"):
        from repro_torch.kernels import ops as kops     # lazy: import cycle
        f = (kops.sq_conv2d_im2col if mode == "square_exact"
             else kops.sq_conv2d_routed)
        return f(x, w, stride=stride, padding=padding, device=device)
    if isinstance(w, PreparedOperand):
        w = w.source
    x, w = _place(x, w, device)
    x4, w4, kind = normalize_conv2d(x, w)
    strides = resolve_stride(stride)
    pads = resolve_padding(padding, x4.shape[2:], w4.shape[2:], strides)
    dt = torch.promote_types(x4.dtype, w4.dtype)
    if mode == "square_virtual":
        # the square contract carries a wide 2c accumulator, so the
        # multiplier form accumulates at the accumulator dtype before the
        # carry and the final halving
        out = conv2d_nchw(x4, w4, strides, pads, sq.accum_dtype(dt))
        out = sq.halve(out + out)
    else:
        out = conv2d_nchw(x4, w4, strides, pads, dt)
    return denormalize_conv2d(out, kind)


# --------------------------------------------------------------------------
# Complex correlation (paper §8, §11) and the IIR filter (paper §5).
# --------------------------------------------------------------------------

def complex_correlate1d(x, w, *, mode: str = "standard",
                        device: Device = None) -> torch.Tensor:
    """Complex valid 1D correlation, CPM4 (paper §8) or CPM3 (paper §11).

    x: complex samples (L,); w: complex kernel (n,).  The kernel slides
    over the samples: z_k = sum_i w_i x_{i+k} with w = c + js, x = x + jy.
    """
    dev = operand_device(x, device)
    xr, xi = split_planes(x, device=dev)
    c, s = split_planes(w, device=dev)
    if mode == "standard":
        re = correlate1d(xr, c) - correlate1d(xi, s)
        im = correlate1d(xi, c) + correlate1d(xr, s)
        return join_planes(re, im)
    n = c.shape[-1]
    acc = sq.accum_dtype(xr.dtype)
    xr, xi, c, s = (t.to(acc) for t in (xr, xi, c, s))
    wr_x = xr.unfold(-1, n, 1)                                # (K, n)
    wi_x = xi.unfold(-1, n, 1)
    if mode == "cpm4":
        # eq 28 / 29 with shared -x^2-y^2 and precomputed Sw (eq 30)
        re2 = _sum(sq.pm(c, wr_x) + sq.pm_neg(s, wi_x), -1)
        im2 = _sum(sq.pm(s, wr_x) + sq.pm(c, wi_x), -1)
        sxy = -(sliding_sum_squares(xr, n) + sliding_sum_squares(xi, n))
        sw = -_sum(sq.square(c) + sq.square(s), -1)
        return join_planes(sq.halve(re2 + sxy + sw),
                           sq.halve(im2 + sxy + sw))
    if mode == "cpm3":
        # eqs 45 / 46 with complex correction Sw (eq 47)
        shared = sq.cpm3_shared(wr_x, wi_x, c)                # (c+x+y)^2
        re2 = _sum(sq.cpm3_real(wr_x, wi_x, c, s, shared=shared), -1)
        im2 = _sum(sq.cpm3_imag(wr_x, wi_x, c, s, shared=shared), -1)
        # data-side common terms: (-(x+y)^2 + y^2) + j(-(x+y)^2 - x^2)
        sxy_re = -sliding_sum_squares(xr + xi, n) \
            + sliding_sum_squares(xi, n)
        sxy_im = -sliding_sum_squares(xr + xi, n) \
            - sliding_sum_squares(xr, n)
        sw_re = _sum(-sq.square(c) + sq.square(c + s), -1)
        sw_im = _sum(-sq.square(c) - sq.square(s - c), -1)
        return join_planes(sq.halve(re2 + sxy_re + sw_re),
                           sq.halve(im2 + sxy_im + sw_im))
    raise ValueError(f"unknown complex conv mode {mode!r}")


def iir_filter(x, b, a, *, mode: str = "standard",
               device: Device = None) -> torch.Tensor:
    """IIR filter (paper §5: "For IIR filters we can apply the same
    principles").

    y_t = sum_i b_i x_{t-i} + sum_j a_j y_{t-j-1}

    The feed-forward taps use the square-based correlation; the feedback
    taps apply the PM substitution per step inside the recurrence: each
    product a_j * y is ((a_j + y)^2 - a_j^2 - y^2) / 2 with the sum of
    squares Sa of the constant coefficients precomputed.  The recurrence is
    a loop over samples that carries the last ``len(a)`` outputs, newest
    first (the JAX package's ``lax.scan``).
    """
    x, b = _place(x, b, device)
    a = torch.as_tensor(a).to(x.device)
    nb, na = b.shape[-1], a.shape[-1]
    acc = sq.accum_dtype(x.dtype)
    xw = F.pad(x.to(acc), (nb - 1, 0))
    ff = correlate1d(xw, b.flip(-1),
                     mode="square" if mode == "square" else "standard")

    aw = a.to(acc)
    sa = _sum(sq.square(aw), -1)                     # precomputed (constants)
    hist = torch.zeros((na,), dtype=acc, device=x.device)
    ys = []
    for f_t in ff:
        if mode == "square":
            pm = _sum(sq.pm(aw, hist), -1)           # sum (a_j + y)^2
            sy = _sum(sq.square(hist), -1)           # y^2 terms (recomputed)
            fb = sq.halve(pm - sa - sy)
        else:
            fb = _sum(aw * hist, -1)
        y_t = f_t + fb
        hist = torch.cat([y_t[None], hist[:-1]])
        ys.append(y_t)
    return torch.stack(ys) if ys else ff
