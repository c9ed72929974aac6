"""Launch planner for the port's CUDA kernels: the PyTorch port of
``repro/kernels/tuning.py``.

Every CUDA kernel of the port instantiates a few launch variants, and each
launch takes one of them from a **plan** chosen here (the C entry points
choose nothing):

=========  ====================  ==========================================
kernel     plan                  variants
=========  ====================  ==========================================
K1         :class:`K1Plan`       output tile 8 x 64 (4 warps) or 32 x 128
K2, K3     :class:`BatchedPlan`  tile rows 1, 4 or 8 x columns 32 or 64
K4         :class:`PagedAttnPlan`  table splits 1..8 (at most nb)
K5, K6     :class:`CpmPlan`      thread tile: the kernel's own, or 1 x 1
K7         :class:`Conv2DPlan`   band (output columns a tile row), splits
=========  ====================  ==========================================

K8 has one launch (``k8_launch_shape``), which it reports: no plan.

No variant changes what a kernel computes: K1, K2 and K3 keep one
summation order under every tile, so they stay equal bit for bit; K4's and
K7's splits add their partials in split order.

Precedence, as the JAX package's: an explicit plan (the wrappers'
``plan=``), then the autotune cache, then the model.

- **Model mode** is each kernel's launch rule, the one its C source used to
  apply itself (:func:`~repro_torch.kernels.sq_matmul.k1_launch_shape`,
  ``k2_launch_shape``, ``k4_splits``, ``cpm_launch_shape``,
  ``k7_launch_shape``).  With no cache entry, every launch is what it was
  before the planner existed.
- **The cache** is a JSON file of the port's own: the path in
  ``$REPRO_TORCH_TUNING_CACHE``, else ``tuning_cache.json`` beside this
  module.  It never reads the JAX package's file or variable
  (``REPRO_TUNING_CACHE``): a cache of Pallas tiles is not a cache of H100
  plans.  Keys are ``<kind>:<shape>:<accumulator dtype>``
  (:func:`matmul_key`, :func:`paged_attn_key`, :func:`conv2d_key`);
  ``route:`` keys hold route overrides (``routing.set_route_override``).
  A miss warns once a key, with the model's entry ready to paste.  Each
  lookup's outcome goes to ``tuning_cache_hits_total`` /
  ``tuning_cache_misses_total`` in the default metrics registry and to a
  ``tuning.cache`` trace event.  ``REPRO_AUTOTUNE=0`` turns the cache off:
  no read, no warning, model mode.
- **Autotune** (:func:`autotune_matmul`, :func:`autotune_conv2d`,
  :func:`autotune_paged_attn`, :func:`autotune_cpm`; CUDA only) times
  every variant of a shape with CUDA events over CUDA-graph replays
  (:func:`time_graph`), holds each against the kernel's plain version (K4:
  its function in float64) before it may win, and writes the winner to the cache with the model's
  variant and time beside it.  ``python3 chip_smoke.py --autotune FILE``
  runs them on the card over the shapes the smoke's main paths launch.

A plan is resolved once per (kind, shape, dtype) and memoised, so a launch
pays one dict lookup; :func:`clear_cache` (and
``core.prepared.clear_plan_cache``) drops the memo.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core import cost_model as cm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["K1Plan", "BatchedPlan", "PagedAttnPlan", "CpmPlan", "Conv2DPlan",
           "PLAN_KINDS", "plan_matmul", "plan_paged_attn", "plan_cpm",
           "plan_conv2d", "candidates_matmul",
           "candidates_paged_attn", "candidates_cpm", "candidates_conv2d",
           "matmul_key", "paged_attn_key", "conv2d_key", "cache_path",
           "CACHE_ENV", "load_cache", "save_cache", "clear_cache",
           "autotune_enabled", "time_graph", "paged_attn_f64",
           "autotune_matmul",
           "autotune_paged_attn", "autotune_cpm", "autotune_conv2d"]

CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
_DEFAULT_CACHE = Path(__file__).resolve().parent / "tuning_cache.json"


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """K1's output tile: 8 rows x 64 columns (4 warps a block) or 32 x 128
    (16 warps); 8 blocks a tile either way."""
    rows: int
    cols: int

    @property
    def code(self) -> int:
        return 0 if (self.rows, self.cols) == (8, 64) else 1


@dataclasses.dataclass(frozen=True)
class BatchedPlan:
    """K2's and K3's tile: ``rows`` (1, 4 or 8) x ``cols`` (32 or 64: 1 or
    2 columns a lane) of one batch element, one 8-warp block each."""
    rows: int
    cols: int


@dataclasses.dataclass(frozen=True)
class PagedAttnPlan:
    """K4's split of each (sequence, kv-head) table into ``splits`` ranges,
    one block and one cluster rank each."""
    splits: int


@dataclasses.dataclass(frozen=True)
class CpmPlan:
    """K5's / K6's thread tile: the kernel's own or (1, 1)."""
    thread_tile: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Conv2DPlan:
    """K7's band (output columns a tile row) and the most blocks a tile's K
    walk is split over; the rest of the launch follows from them."""
    band: int
    splits: int


PLAN_KINDS = {"sq_matmul": K1Plan, "sq_matmul_batched": BatchedPlan,
              "sq_matmul_folded": BatchedPlan, "sq_paged_attn": PagedAttnPlan,
              "cpm3_matmul": CpmPlan, "cpm4_matmul": CpmPlan,
              "sq_conv2d": Conv2DPlan}


def _entry(plan) -> dict:
    d = dataclasses.asdict(plan)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def _from_entry(kind: str, entry: dict):
    cls = PLAN_KINDS[kind]
    fields = {f.name: entry[f.name] for f in dataclasses.fields(cls)}
    if "thread_tile" in fields:
        fields["thread_tile"] = tuple(int(v) for v in fields["thread_tile"])
    else:
        fields = {k: int(v) for k, v in fields.items()}
    return cls(**fields)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# --------------------------------------------------------------------------
# The cache
# --------------------------------------------------------------------------

_CACHE: Dict[str, dict] = {}          # loaded files, by path
_WARNED_MISS: set = set()
_PLANS: Dict[tuple, object] = {}      # resolved plans: (key, cache path)
# bound once: the planner runs at every launch's first resolution
_HIT_COUNTER = obs_metrics.default_registry().counter(
    "tuning_cache_hits_total", help="autotune-cache lookups served")
_MISS_COUNTER = obs_metrics.default_registry().counter(
    "tuning_cache_misses_total",
    help="autotune-cache lookups that fell back to the model")


def autotune_enabled() -> bool:
    """``REPRO_AUTOTUNE=0`` disables the cache: no file read, no miss
    warning, model mode (the JAX package's meaning)."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def cache_path() -> str:
    """The port's cache file: ``$REPRO_TORCH_TUNING_CACHE``, else
    ``tuning_cache.json`` beside this module."""
    return os.environ.get(CACHE_ENV) or str(_DEFAULT_CACHE)


def load_cache(path: Optional[str] = None) -> dict:
    p = path or cache_path()
    if p not in _CACHE:
        try:
            with open(p) as f:
                _CACHE[p] = json.load(f)
        except (OSError, ValueError):
            _CACHE[p] = {}
    return _CACHE[p]


def save_cache(cache: dict, path: Optional[str] = None) -> str:
    p = path or cache_path()
    with open(p, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    _CACHE[p] = dict(cache)
    clear_memo()
    return p


def clear_memo() -> None:
    """Drop the resolved plans and routes (they are re-resolved from the
    cache or the model at their next launch)."""
    _PLANS.clear()
    from repro_torch.kernels import routing    # lazy: routing imports us
    routing.clear_route_memo()


def clear_cache() -> None:
    """Drop the loaded files, the memo and the warn-once ledger (tests;
    after editing a cache file)."""
    _CACHE.clear()
    _WARNED_MISS.clear()
    clear_memo()


def _note_cache_lookup(key: str, hit: bool) -> None:
    obs_trace.event("tuning.cache", cat="dispatch", key=key, hit=hit)
    (_HIT_COUNTER if hit else _MISS_COUNTER).inc()


_AUTOTUNE_FN = {"sq_paged_attn": "autotune_paged_attn",
                "sq_conv2d": "autotune_conv2d", "cpm3_matmul": "autotune_cpm",
                "cpm4_matmul": "autotune_cpm"}


def _warn_cache_miss(key: str, plan) -> None:
    if key in _WARNED_MISS:
        return
    _WARNED_MISS.add(key)
    fn = _AUTOTUNE_FN.get(key.split(":", 1)[0], "autotune_matmul")
    warnings.warn(
        f"autotune cache miss for {key}; falling back to the model plan.  "
        f"Run kernels.tuning.{fn} once for this shape on the card to cache "
        f"a measured winner, or set REPRO_AUTOTUNE=0 to silence.  Model "
        f"entry, ready to paste into {cache_path()}: "
        + json.dumps({key: _entry(plan)}, sort_keys=True), stacklevel=4)


def _resolve(kind: str, sig: tuple, key: Callable, model: Callable,
             valid: Callable):
    """The plan of one (kind, shape, dtype) ``sig``, memoised: a repeated
    launch pays one dict lookup.  On its first resolution: the cache's
    entry at ``key()`` where autotune is on and it has one, else the
    model's."""
    use = autotune_enabled()
    memo = (kind, sig, cache_path() if use else None)
    got = _PLANS.get(memo)
    if got is not None:
        return got
    plan = None
    if use:
        key = key()
        entry = load_cache().get(key)
        if entry is not None:
            plan = _from_entry(kind, entry)
            if not valid(plan):
                raise ValueError(f"tuning cache {cache_path()}: entry {key} "
                                 f"= {entry} is not a variant the kernel "
                                 f"has at this shape")
            _note_cache_lookup(key, hit=True)
        else:
            plan = model()
            _note_cache_lookup(key, hit=False)
            _warn_cache_miss(key, plan)
    else:
        plan = model()
    _PLANS[memo] = plan
    return plan


def _explicit(kind: str, plan, valid: Callable):
    if not isinstance(plan, PLAN_KINDS[kind]) or not valid(plan):
        raise ValueError(f"{kind}: {plan} is not a launch variant of this "
                         f"shape")
    return plan


# --------------------------------------------------------------------------
# Keys, candidates and the model
# --------------------------------------------------------------------------

_MAX_GRID_YZ = 65535


def matmul_key(kind: str, m: int, n: int, k: int, dtype,
               batch: int = 1) -> str:
    """``<kind>:<m>x<n>x<k>:<dtype>`` (``<kind>:<B>b:...`` for a batch of
    more than one), the JAX package's layout; ``dtype`` is the accumulator
    dtype."""
    if batch > 1:
        return f"{kind}:{batch}b:{m}x{n}x{k}:{_dtype_name(dtype)}"
    return f"{kind}:{m}x{n}x{k}:{_dtype_name(dtype)}"


def candidates_matmul(kind: str, m: int, n: int, k: int,
                      batch: int = 1) -> list:
    """Every variant of K1 (``kind="sq_matmul"``) or K2/K3 that can launch
    at this shape (grid y and z within 65535)."""
    if kind == "sq_matmul":
        return [p for p in (K1Plan(8, 64), K1Plan(32, 128))
                if -(-m // p.rows) <= _MAX_GRID_YZ]
    return [BatchedPlan(r, c) for r in (1, 4, 8) for c in (32, 64)
            if -(-m // r) <= _MAX_GRID_YZ and -(-n // c) <= _MAX_GRID_YZ]


def _model_matmul(kind: str, m: int, n: int, batch: int):
    from repro_torch.kernels import sq_matmul as smm   # lazy: it imports us
    if kind == "sq_matmul":
        s = smm.k1_launch_shape(m, n)
        return K1Plan(s["rows"], s["cols"])
    s = smm.k2_launch_shape(batch, m, n)
    return BatchedPlan(s["rows"], s["cols"])


def plan_matmul(m: int, n: int, k: int, dtype=torch.float32, *,
                batch: int = 1, kind: str = "sq_matmul", plan=None):
    """The launch plan of K1 (``kind="sq_matmul"``), K2
    (``"sq_matmul_batched"``) or K3 (``"sq_matmul_folded"``) for an (m, k)
    @ (k, n) of ``batch`` elements in accumulator dtype ``dtype``.

    >>> plan_matmul(8, 768, 768)
    K1Plan(rows=8, cols=64)
    >>> plan_matmul(8, 768, 768, plan=K1Plan(32, 128))
    K1Plan(rows=32, cols=128)
    """
    valid = lambda p: p in candidates_matmul(  # noqa: E731
        kind, m, n, k, batch)
    if plan is not None:
        return _explicit(kind, plan, valid)
    return _resolve(kind, (m, n, k, batch, dtype),
                    lambda: matmul_key(kind, m, n, k, dtype, batch),
                    lambda: _model_matmul(kind, m, n, batch), valid)


def paged_attn_key(batch: int, s: int, kv_heads: int, group: int, hd: int,
                   nb: int, block_size: int, dtype) -> str:
    """``sq_paged_attn:<B>b:<S*G>x<hd>x<block_size>:nb<nb>:kv<KV>:<pool
    dtype>``: the JAX key's score tile and block, and what K4's split count
    depends on."""
    return (f"sq_paged_attn:{batch}b:{s * group}x{hd}x{block_size}:nb{nb}:"
            f"kv{kv_heads}:{_dtype_name(dtype)}")


def candidates_paged_attn(batch: int, s: int, kv_heads: int, group: int,
                          hd: int, nb: int, block_size: int,
                          itemsize: int = 4) -> list:
    """Every split count K4 can launch with: 1..min(8, nb), within one
    block's shared memory."""
    from repro_torch.kernels import sq_paged_attn as spa
    return [PagedAttnPlan(z) for z in range(1, min(spa.MAX_SPLITS, nb) + 1)
            if spa.smem_bytes(s * group, block_size, hd, itemsize,
                              -(-nb // z)) <= spa._SMEM_MAX]


def plan_paged_attn(batch: int, s: int, kv_heads: int, group: int, hd: int,
                    nb: int, block_size: int, dtype=torch.float32, *,
                    sms: int = cm.H100_SMS, plan=None) -> PagedAttnPlan:
    """K4's plan: ``dtype`` is the pools' dtype (f32 or bf16), ``sms`` the
    card's SM count, which the model rule (``k4_splits``) reads."""
    from repro_torch.kernels import sq_paged_attn as spa
    valid = lambda p: p in candidates_paged_attn(  # noqa: E731
        batch, s, kv_heads, group, hd, nb, block_size, dtype.itemsize)
    if plan is not None:
        return _explicit("sq_paged_attn", plan, valid)
    return _resolve("sq_paged_attn",
                    (batch, s, kv_heads, group, hd, nb, block_size, dtype),
                    lambda: paged_attn_key(batch, s, kv_heads, group, hd, nb,
                                           block_size, dtype),
                    lambda: PagedAttnPlan(spa.k4_splits(batch, kv_heads, nb,
                                                        sms)), valid)


def candidates_cpm(kind: str, m: int, n: int) -> list:
    from repro_torch.kernels import cpm3_matmul as c3
    own = c3.K5_TILE if kind == "cpm3_matmul" else _k6_tile()
    return [CpmPlan(t) for t in (tuple(own), (1, 1))
            if -(-n // (16 * t[1])) <= _MAX_GRID_YZ]


def _k6_tile():
    from repro_torch.kernels import cpm4_matmul as c4
    return c4.K6_TILE


def plan_cpm(kind: str, m: int, n: int, k: int, dtype=torch.float32, *,
             plan=None) -> CpmPlan:
    """K5's (``kind="cpm3_matmul"``) or K6's (``"cpm4_matmul"``) thread
    tile for an (m, k) @ (k, n) of f32 planes."""
    from repro_torch.kernels import cpm3_matmul as c3
    own = c3.K5_TILE if kind == "cpm3_matmul" else _k6_tile()
    valid = lambda p: p in candidates_cpm(kind, m, n)   # noqa: E731
    if plan is not None:
        return _explicit(kind, plan, valid)
    return _resolve(kind, (m, n, k, dtype),
                    lambda: matmul_key(kind, m, n, k, dtype),
                    lambda: CpmPlan(tuple(
                        c3.cpm_launch_shape(m, n, own)["thread_tile"])),
                    valid)


def conv2d_key(xshape, n_filters: int, khw, stride, pads, dtype) -> str:
    """The JAX key (``sq_conv2d:<h>x<w>:k<kh>x<kw>:s<sh>x<sv>:c<cin>-><cout>
    :<dtype>`` over the padded input, ``:b<B>`` when batched) with the
    leading pads, which K7's window alignment reads."""
    B, C, H, W = xshape
    (ph0, ph1), (pw0, pw1) = pads
    h, w = H + ph0 + ph1, W + pw0 + pw1
    base = (f"sq_conv2d:{h}x{w}:k{khw[0]}x{khw[1]}:s{stride[0]}x{stride[1]}"
            f":c{C}->{n_filters}:{_dtype_name(dtype)}:p{ph0}x{pw0}")
    return f"{base}:b{B}" if B > 1 else base


def candidates_conv2d(xshape, n_filters: int, khw, stride, pads,
                      elem: int = 4, x_aligned: bool = True) -> list:
    """K7's variants at this shape: bands 8, 16 and the rule's (each at most
    ow) by every split count 1..min(8, K tiles)."""
    from repro_torch.kernels import sq_conv2d as k7
    rule = k7.k7_launch_shape(xshape, n_filters, khw, stride, pads,
                              cm.H100_SMS, elem=elem, x_aligned=x_aligned)
    _, ow = k7.conv2d_out_hw(xshape[2:], khw, stride, pads)
    bands = sorted({min(ow, 8), min(ow, 16), rule["band"]})
    out = []
    for band in bands:
        k_tiles = k7.k7_launch_shape(
            xshape, n_filters, khw, stride, pads, cm.H100_SMS, elem=elem,
            x_aligned=x_aligned, band=band, splits=1)["k_tiles"]
        out += [Conv2DPlan(band, z)
                for z in range(1, min(k7._MAX_SPLITS, k_tiles) + 1)]
    return out


def plan_conv2d(xshape, n_filters: int, khw, stride, pads,
                dtype=torch.float32, *, sms: int = cm.H100_SMS,
                x_aligned: bool = True, plan=None) -> Conv2DPlan:
    """K7's plan for a (B, C, H, W) input, ``n_filters`` filters of ``khw``
    taps under ``stride`` and explicit ``pads``; ``dtype`` the accumulator
    dtype, ``sms`` the card's SM count (the model's split rule reads it)."""
    from repro_torch.kernels import sq_conv2d as k7
    elem = dtype.itemsize
    valid = lambda p: p in candidates_conv2d(  # noqa: E731
        xshape, n_filters, khw, stride, pads, elem, x_aligned)
    if plan is not None:
        return _explicit("sq_conv2d", plan, valid)

    def model():
        s = k7.k7_launch_shape(xshape, n_filters, khw, stride, pads, sms,
                               elem=elem, x_aligned=x_aligned)
        return Conv2DPlan(s["band"], s["grid"][2])

    def key():
        k = conv2d_key(xshape, n_filters, khw, stride, pads, dtype)
        return k if x_aligned else k + ":unaligned"

    return _resolve("sq_conv2d", (tuple(xshape), n_filters, tuple(khw),
                                  tuple(stride), tuple(map(tuple, pads)),
                                  dtype, x_aligned), key, model, valid)


# --------------------------------------------------------------------------
# Autotune (CUDA only)
# --------------------------------------------------------------------------

def time_graph(fns, reps: int = 20, replays: int = 5) -> float:
    """Mean device ms of one call: at least ``reps`` calls, cycling through
    ``fns``, captured in one CUDA graph and replayed ``replays`` times
    between CUDA events (the host's launch cost is not in it)."""
    reps = max(reps, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def _f32_tol(k: int, *operands) -> float:
    """The square form's f32 bound: k terms, each rounded relative to
    (max|a| + max|b|)^2."""
    top = sum(float(t.abs().max()) for t in operands)
    return k * 2.0 ** -23 * top * top


def _tune(kind: str, key: str, cands: list, model, launch: Callable,
          plain, tol: float, cost: Callable, reps: int, verbose: bool,
          exact: bool = False) -> dict:
    """Time every candidate of one key, each held to ``plain`` first; the
    winner's entry with the model's variant and time beside it."""
    results = []
    for plan in sorted(cands, key=lambda p: cost(p).predicted_ms):
        out = launch(plan)
        outs = out if isinstance(out, tuple) else (out,)
        refs = plain if isinstance(plain, tuple) else (plain,)
        err = max(float((o.double() - r.double()).abs().max())
                  for o, r in zip(outs, refs))
        ok = err == 0 if exact else err <= tol
        if not ok:
            raise RuntimeError(f"autotune {key}: {plan} is off its plain "
                               f"version by {err:.3e} (bound {tol:.3e})")
        ms = time_graph([lambda p=plan: launch(p)], reps=reps)
        results.append((ms, plan, err))
        if verbose:
            print(f"  {key} {plan}: {ms * 1e3:.2f} us (model "
                  f"{cost(plan).predicted_ms * 1e3:.2f} us), err {err:.2e}",
                  flush=True)
    best_ms, best, _ = min(results, key=lambda r: r[0])
    rule_ms = next(ms for ms, p, _ in results if p == model)
    return {**_entry(best), "us_per_call": best_ms * 1e3,
            "rule": _entry(model), "rule_us": rule_ms * 1e3,
            "variants": len(results),
            "max_abs_err": max(e for _, _, e in results)}


def _randn(shape, gen, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(
        device=device, dtype=dtype)


def _store(results: Dict[str, dict], path: Optional[str]) -> dict:
    cache = dict(load_cache(path))
    cache.update(results)
    save_cache(cache, path)
    return cache


def autotune_matmul(shapes: Iterable[tuple], dtype=torch.float32, *,
                    kind: str = "sq_matmul", path: Optional[str] = None,
                    reps: int = 20, seed: int = 0, device=None,
                    verbose: bool = False) -> dict:
    """Time every K1 (``kind="sq_matmul"``; ``shapes`` of (m, n, k)) or
    K2/K3 (``"sq_matmul_batched"`` / ``"sq_matmul_folded"``; shapes of
    (batch, m, n, k)) variant on the card, each held to the plain version
    (bit for bit on int32), and write each shape's winner to the cache at
    ``path`` (default :func:`cache_path`).  Returns the new entries."""
    from repro_torch.core import squares as sq
    from repro_torch.kernels import sq_matmul as smm
    dev = torch.device(device or "cuda")
    gen = torch.Generator().manual_seed(seed)
    acc = sq.accum_dtype(dtype)
    found = {}
    for shape in shapes:
        nb, m, n, k = (1, *shape) if kind == "sq_matmul" else shape
        lead = () if kind == "sq_matmul" else (nb,)
        if acc.is_floating_point:
            aw = _randn(lead + (m, k), gen, dev)
            bw = _randn(lead + (k, n), gen, dev)
        else:
            aw = torch.randint(-128, 128, lead + (m, k), generator=gen,
                               dtype=torch.int32).to(dev)
            bw = torch.randint(-128, 128, lead + (k, n), generator=gen,
                               dtype=torch.int32).to(dev)
        sa, sb = sq.row_correction(aw, dim=-1), sq.col_correction(bw, dim=-2)
        if kind == "sq_matmul":
            fn = smm.sq_matmul_k1
            ref = smm.sq_matmul_plain(aw, bw, sa, sb)
            cost = lambda p: cm.k1_cost(m, n, k, p.rows, p.cols)  # noqa: E731
        else:
            fn = smm.sq_matmul_k3 if kind == "sq_matmul_folded" \
                else smm.sq_matmul_k2
            # the plain version in slices of the batch: its live term
            # tensor is (slice, m, 16, n)
            per = max(1, (1 << 28) // max(1, m * 16 * n))
            ref = torch.cat([smm.sq_matmul_batched_plain(
                aw[i:i + per], bw[i:i + per], sa[i:i + per], sb[i:i + per])
                for i in range(0, nb, per)])
            cost = lambda p: cm.batched_cost(  # noqa: E731
                nb, m, n, k, p.rows, p.cols)
        key = matmul_key(kind, m, n, k, acc, nb)
        model = _model_matmul(kind, m, n, nb)
        found[key] = _tune(
            kind, key, candidates_matmul(kind, m, n, k, nb), model,
            lambda p: fn(aw, bw, sa, sb, plan=p), ref,
            _f32_tol(k, aw, bw), cost, reps, verbose,
            exact=not acc.is_floating_point)
    _store(found, path)
    return found


def paged_attn_f64(q, kp, vp, tables, pos_pool, q_pos, bs: int, *,
                   window=None, softcap: float = 0.0):
    """K4's function in float64 with the multiplier: the reference of long
    tables, where the plain version's own f32 sums of (p + v)^2 over the
    window reach K4's 1e-4."""
    idx = (tables.long()[:, :, None] * bs + torch.arange(
        bs, device=tables.device)).reshape(tables.shape[0], -1)
    k = kp[idx].double().permute(0, 2, 1, 3)[:, :, None]   # (B,KV,1,T,hd)
    v = vp[idx].double().permute(0, 2, 1, 3)[:, :, None]
    s = q.double().permute(0, 2, 3, 1, 4) @ k.transpose(-1, -2)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kv_pos, qp = pos_pool[idx][:, None, :], q_pos[:, :, None]
    valid = (kv_pos <= qp) & (kv_pos < 2 ** 29)
    if window is not None:
        valid &= (qp - kv_pos) < window
    s = s.masked_fill(~valid[:, None, None], -1e30)
    return (torch.softmax(s, dim=-1) @ v).permute(0, 3, 1, 2, 4)


def autotune_paged_attn(shapes: Iterable[tuple], dtype=torch.float32, *,
                        path: Optional[str] = None, reps: int = 20,
                        seed: int = 0, device=None,
                        verbose: bool = False) -> dict:
    """Time every K4 split count at each (batch, s, kv_heads, group, hd,
    nb, block_size) over a pool of ``dtype``: each sequence's table a
    distinct run of blocks, every position written and attended (the query
    at the table's last position), each variant held within 1e-4 to the
    function in float64 (at long tables the plain version's own f32 sums
    reach that tolerance)."""
    from repro_torch.kernels import sq_paged_attn as spa
    dev = torch.device(device or "cuda")
    gen = torch.Generator().manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    found = {}
    for (B, S, KV, G, hd, nb, bs) in shapes:
        blocks = 1 + B * nb                                  # block 0: null
        q = _randn((B, S, KV, G, hd), gen, dev) * hd ** -0.5
        kp = _randn((blocks * bs, KV, hd), gen, dev, dtype)
        vp = _randn((blocks * bs, KV, hd), gen, dev, dtype)
        tables = (1 + torch.arange(B * nb, dtype=torch.int32)).reshape(
            B, nb).to(dev)
        pos = torch.full((blocks * bs,), 2 ** 30, dtype=torch.int32)
        for b in range(B):
            for j in range(nb):
                blk = 1 + b * nb + j
                pos[blk * bs:(blk + 1) * bs] = torch.arange(
                    j * bs, (j + 1) * bs, dtype=torch.int32)
        pos = pos.to(dev)
        q_pos = torch.arange(nb * bs - S, nb * bs, dtype=torch.int32).expand(
            B, S).contiguous().to(dev)
        ref = paged_attn_f64(q, kp, vp, tables, pos, q_pos, bs)
        model = PagedAttnPlan(spa.k4_splits(B, KV, nb, sms))
        key = paged_attn_key(B, S, KV, G, hd, nb, bs, dtype)
        item = kp.element_size()
        found[key] = _tune(
            "sq_paged_attn", key,
            candidates_paged_attn(B, S, KV, G, hd, nb, bs, item), model,
            lambda p: spa.sq_paged_attn_k4(q, kp, vp, tables, pos, q_pos,
                                           block_size=bs, plan=p),
            ref, 1e-4, lambda p: cm.paged_attn_cost(
                B, S, KV, G, hd, nb, bs, p.splits, spa.smem_bytes(
                    S * G, bs, hd, item, -(-nb // p.splits)), item),
            reps, verbose)
    _store(found, path)
    return found


def autotune_cpm(shapes: Iterable[tuple], *, kind: str = "cpm3_matmul",
                 path: Optional[str] = None, reps: int = 20, seed: int = 0,
                 device=None, verbose: bool = False) -> dict:
    """Time both thread tiles of K5 (``kind="cpm3_matmul"``) or K6
    (``"cpm4_matmul"``) at each (m, n, k) of unit-normal f32 planes, each
    held to the plain version within the square form's bound (2k terms of
    up to the four planes' sum squared)."""
    from repro_torch.kernels import cpm3_matmul as c3
    from repro_torch.kernels import cpm4_matmul as c4
    from repro_torch.kernels.ops import cpm3_corrections, cpm4_corrections
    dev = torch.device(device or "cuda")
    gen = torch.Generator().manual_seed(seed)
    found = {}
    for (m, n, k) in shapes:
        a, b = _randn((m, k), gen, dev), _randn((m, k), gen, dev)
        c, s = _randn((k, n), gen, dev), _randn((k, n), gen, dev)
        if kind == "cpm3_matmul":
            corrs = cpm3_corrections(a, b, c, s)
            fn, plain, own = c3.cpm3_matmul_k5, c3.cpm3_matmul_plain, c3.K5_TILE
            planes, slots = (3, 3), 6
        else:
            corrs = cpm4_corrections(a, b, c, s)
            fn, plain, own = c4.cpm4_matmul_k6, c4.cpm4_matmul_plain, c4.K6_TILE
            planes, slots = (2, 2), 8
        ref = plain(a, b, c, s, *corrs)
        key = matmul_key(kind, m, n, k, torch.float32)
        model = CpmPlan(tuple(c3.cpm_launch_shape(m, n, own)["thread_tile"]))
        found[key] = _tune(
            kind, key, candidates_cpm(kind, m, n), model,
            lambda p: fn(a, b, c, s, *corrs, plan=p), ref,
            2 * _f32_tol(k, a, b, c, s), lambda p: cm.cpm_cost(
                m, n, k, p.thread_tile, planes, slots, own), reps, verbose)
    _store(found, path)
    return found


def autotune_conv2d(shapes: Iterable[tuple], dtype=torch.float32, *,
                    path: Optional[str] = None, reps: int = 20,
                    seed: int = 0, device=None,
                    verbose: bool = False) -> dict:
    """Time every K7 (band, splits) variant at each (xshape, n_filters,
    khw, stride, pads) of unit-normal f32 operands (int32 of int8 values
    with ``dtype=torch.int32``, held bit for bit), each held to the plain
    version within kh*kw*cin terms of the f32 bound."""
    from repro_torch.core import squares as sq
    from repro_torch.kernels import sq_conv2d as k7
    dev = torch.device(device or "cuda")
    gen = torch.Generator().manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    found = {}
    for (xshape, N, khw, stride, pads) in shapes:
        B, C, H, W = xshape
        kvol = khw[0] * khw[1] * C
        if dtype.is_floating_point:
            xw = _randn(xshape, gen, dev)
            wt = _randn((kvol, N), gen, dev)
        else:
            xw = torch.randint(-128, 128, xshape, generator=gen,
                               dtype=torch.int32).to(dev)
            wt = torch.randint(-128, 128, (kvol, N), generator=gen,
                               dtype=torch.int32).to(dev)
        sw = sq.col_correction(wt, dim=0)
        ref = k7.sq_conv2d_plain(xw, wt, sw, khw, stride, pads)
        oh, ow = k7.conv2d_out_hw((H, W), khw, stride, pads)
        rule = k7.k7_launch_shape(xshape, N, khw, stride, pads, sms)
        model = Conv2DPlan(rule["band"], rule["grid"][2])
        key = conv2d_key(xshape, N, khw, stride, pads, dtype)

        def cost(p):
            s = k7.k7_launch_shape(xshape, N, khw, stride, pads, sms,
                                   band=p.band, splits=p.splits)
            return cm.conv2d_cost(s, B, C, N, oh, ow, khw[0], khw[1],
                                  H, W)

        found[key] = _tune(
            "sq_conv2d", key, candidates_conv2d(xshape, N, khw, stride, pads),
            model, lambda p: k7.sq_conv2d_k7(xw, wt, sw, khw=khw,
                                             stride=stride, pads=pads,
                                             plan=p),
            ref, _f32_tol(kvol, xw, wt) if dtype.is_floating_point else 0.0,
            cost, reps, verbose, exact=not dtype.is_floating_point)
    _store(found, path)
    return found
