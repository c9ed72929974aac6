"""Op counting and the contraction audit: the PyTorch port of
``repro/core/counting.py``.

Two counters back the paper's claims.

- :class:`OpCounter` runs the square-based algorithms on an instrumented
  numpy backend and counts every scalar square the datapath performs, so
  the closed forms of eqs (6), (20) and (36) can be checked exactly.
  Conventions: a square is one squarer firing; correction terms count
  their squares; additions are free in the paper's accounting (counted
  anyway); CPM3's shared ``(c+a+b)^2`` counts once.
- :class:`ContractionCounter` tallies which fraction of a model's
  contraction volume runs in square form.  Every
  :func:`repro_torch.core.einsum.fs_einsum` call notes its ``B*M*K*N``
  scalar multiplies and its served mode into each open counter
  (:func:`track_contractions`).  An eager call notes once per execution:
  a Python loop notes every iteration, and :func:`count_scale` is needed
  only where one call stands for ``n`` executions.  A region that
  training rematerialises in its backward (``torch.utils.checkpoint``)
  runs its Python twice; its second run is :func:`recomputing`, which
  notes nothing, so each contraction of a step is noted once, as the JAX
  package's trace-time notes are.  Kernel launch counters still count the
  recompute's launches: they count what executed.
- The compiled audit covers calls replayed from CUDA graphs
  (:mod:`repro_torch.core.graphs`), where Python does not run again: under
  :func:`compiled_audit` the dispatcher also emits a runtime note
  (:func:`emit_runtime_note`) into the capture's ledger, and every replay
  tallies it into each open :func:`track_compiled_contractions` counter.

    with counting.track_contractions() as ctr:
        model.forward(params, tokens)
    assert ctr.fraction_square >= 0.9

``ctr.multiplies_replaced`` is the paper's headline quantity: every scalar
multiply of a square-routed contraction is replaced by one square (plus
the asymptotically free corrections).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Dict, List

import numpy as np

__all__ = ["OpCounter", "pm_matmul_counted", "standard_matmul_counted",
           "cpm4_matmul_counted", "cpm3_matmul_counted",
           "real_matmul_square_count", "cpm4_square_count",
           "cpm3_square_count", "ContractionRecord", "ContractionCounter",
           "track_contractions", "count_scale", "note_contraction",
           "recomputing", "remat", "SQUARE_MODES", "GRAD_SITE_SUFFIXES",
           "EmptyAuditWarning",
           "compiled_audit", "compiled_audit_enabled", "emit_runtime_note",
           "land_runtime_note", "track_compiled_contractions"]


class EmptyAuditWarning(UserWarning):
    """A :func:`track_contractions` region closed with no records: the
    region ran no ``fs_einsum`` (for example, only code that never reaches
    the dispatcher), so every fraction would read 0.  Pass
    ``allow_empty=True`` where an empty region is expected."""


@dataclasses.dataclass
class OpCounter:
    squares: int = 0
    mults: int = 0
    adds: int = 0

    def sq(self, x: np.ndarray) -> np.ndarray:
        """Squaring primitive: counts one square per scalar element."""
        self.squares += int(x.size)
        return x * x

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = a * b
        self.mults += int(out.size)
        return out

    def add(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = a + b
        self.adds += int(np.broadcast(a, b).size)
        return out


# ---------------------------------------------------------------- closed forms
def real_matmul_square_count(m: int, n: int, p: int) -> int:
    """Paper §3: M*N*P PM squares + M*N (Sa) + N*P (Sb)."""
    return m * n * p + m * n + n * p


def cpm4_square_count(m: int, n: int, p: int) -> int:
    """Paper §6: 4*M*N*P + 2*M*N + 2*N*P."""
    return 4 * m * n * p + 2 * m * n + 2 * n * p


def cpm3_square_count(m: int, n: int, p: int) -> int:
    """Paper §9: 3*M*N*P + 3*M*N + 3*N*P."""
    return 3 * m * n * p + 3 * m * n + 3 * n * p


# ------------------------------------------------------------------- executors
def standard_matmul_counted(a, b, ctr: OpCounter):
    """The multiplier baseline, counting every scalar multiply."""
    m, n = a.shape
    n2, p = b.shape
    if n != n2:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    out = np.zeros((m, p), dtype=np.result_type(a, b))
    for k in range(n):
        out += ctr.mul(a[:, k:k + 1], b[k:k + 1, :])
    return out


def pm_matmul_counted(a, b, ctr: OpCounter):
    """Square-based real matmul, counting every squarer firing (paper §3)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    m, n = a.shape
    p = b.shape[1]
    sa = -np.sum(ctr.sq(a), axis=1)          # M*N squares
    sb = -np.sum(ctr.sq(b), axis=0)          # N*P squares
    acc2 = np.broadcast_to(sa[:, None] + sb[None, :], (m, p)).copy()
    for k in range(n):                       # stream like the systolic array
        acc2 += ctr.sq(a[:, k:k + 1] + b[k:k + 1, :])   # M*P squares a step
    return acc2 / 2


def cpm4_matmul_counted(x, y, ctr: OpCounter):
    """Complex matmul with 4 squares per multiply, counted (paper §6)."""
    a, b = np.real(x).astype(np.float64), np.imag(x).astype(np.float64)
    c, s = np.real(y).astype(np.float64), np.imag(y).astype(np.float64)
    m, n = a.shape
    p = c.shape[1]
    sx = -(np.sum(ctr.sq(a), 1) + np.sum(ctr.sq(b), 1))   # 2*M*N squares
    sy = -(np.sum(ctr.sq(c), 0) + np.sum(ctr.sq(s), 0))   # 2*N*P squares
    re2 = np.broadcast_to(sx[:, None] + sy[None, :], (m, p)).copy()
    im2 = re2.copy()
    for k in range(n):
        ak, bk = a[:, k:k + 1], b[:, k:k + 1]
        ck, sk = c[k:k + 1, :], s[k:k + 1, :]
        re2 += ctr.sq(ak + ck) + ctr.sq(bk - sk)          # 2*M*P squares
        im2 += ctr.sq(bk + ck) + ctr.sq(ak + sk)          # 2*M*P squares
    return re2 / 2 + 1j * (im2 / 2)


def cpm3_matmul_counted(x, y, ctr: OpCounter):
    """Complex matmul with 3 squares per multiply, counted (paper §9).

    The shared square (c+a+b)^2 is computed and counted once per (h, i, k).
    """
    a, b = np.real(x).astype(np.float64), np.imag(x).astype(np.float64)
    c, s = np.real(y).astype(np.float64), np.imag(y).astype(np.float64)
    m, n = a.shape
    p = c.shape[1]
    # eq 33 / 35 corrections: 3*M*N + 3*N*P squares in all
    sq_ab = ctr.sq(a + b)                                  # M*N
    sab = np.sum(-sq_ab + ctr.sq(b), axis=1)               # + M*N
    sba = np.sum(-sq_ab - ctr.sq(a), axis=1)               # + M*N
    sq_c = ctr.sq(c)                                       # N*P
    scs = np.sum(-sq_c + ctr.sq(c + s), axis=0)            # + N*P
    ssc = np.sum(-sq_c - ctr.sq(s - c), axis=0)            # + N*P
    re2 = np.broadcast_to(sab[:, None] + scs[None, :], (m, p)).copy()
    im2 = np.broadcast_to(sba[:, None] + ssc[None, :], (m, p)).copy()
    for k in range(n):
        ak, bk = a[:, k:k + 1], b[:, k:k + 1]
        ck, sk = c[k:k + 1, :], s[k:k + 1, :]
        shared = ctr.sq(ck + ak + bk)                      # M*P, counted ONCE
        re2 += shared - ctr.sq(bk + ck + sk)               # + M*P
        im2 += shared + ctr.sq(ak + sk - ck)               # + M*P
    return re2 / 2 + 1j * (im2 / 2)


# --------------------------------------------------------------------------
# Whole-model contraction accounting
# --------------------------------------------------------------------------

# Modes whose contraction volume is square-form routed (every mode of the
# dispatcher but the multiplier baseline).
SQUARE_MODES = ("square_virtual", "square_exact", "square_scan",
                "square_pallas")

# Site-name suffixes of the backward contractions (dL/dx, dL/dW) of a
# square-routed training step: the counter splits fractions on them.
GRAD_SITE_SUFFIXES = (".bwd_x", ".bwd_w")


@dataclasses.dataclass
class ContractionRecord:
    site: str
    spec: str
    mode: str
    mults: int              # B*M*K*N scalar multiplies (times count_scale)
    demoted: bool = False   # served standard because the route-health
                            # breaker (kernels/routing.RouteHealth) tripped


@dataclasses.dataclass
class ContractionCounter:
    """Tally of fs_einsum contraction volume, split by dispatch mode."""
    records: List[ContractionRecord] = dataclasses.field(default_factory=list)

    def record(self, site: str, spec: str, mode: str, mults: int,
               demoted: bool = False) -> None:
        self.records.append(ContractionRecord(site, spec, mode, mults,
                                              demoted))

    @property
    def total_mults(self) -> int:
        return sum(r.mults for r in self.records)

    @property
    def square_mults(self) -> int:
        return sum(r.mults for r in self.records if r.mode in SQUARE_MODES)

    @property
    def multiplies_replaced(self) -> int:
        """Scalar multiplies replaced by a single square each (paper §3)."""
        return self.square_mults

    @property
    def fraction_square(self) -> float:
        tot = self.total_mults
        return (self.square_mults / tot) if tot else 0.0

    # ---- backward split (sites <site>.bwd_x / <site>.bwd_w) ----
    @property
    def bwd_mults(self) -> int:
        """Contraction volume noted by backward call sites."""
        return sum(r.mults for r in self.records
                   if r.site.endswith(GRAD_SITE_SUFFIXES))

    @property
    def square_bwd_mults(self) -> int:
        return sum(r.mults for r in self.records
                   if r.site.endswith(GRAD_SITE_SUFFIXES)
                   and r.mode in SQUARE_MODES)

    @property
    def fraction_square_bwd(self) -> float:
        """Of the backward contraction volume, the square-routed fraction."""
        tot = self.bwd_mults
        return (self.square_bwd_mults / tot) if tot else 0.0

    @property
    def demoted_mults(self) -> int:
        """Contraction volume served on the standard route because the
        route-health breaker demoted its call site (the numerics guard,
        :mod:`repro_torch.core.guards`)."""
        return sum(r.mults for r in self.records if r.demoted)

    @property
    def fraction_demoted(self) -> float:
        tot = self.total_mults
        return (self.demoted_mults / tot) if tot else 0.0

    def demoted_sites(self) -> List[str]:
        """Call sites that served any demoted contraction."""
        return sorted({r.site for r in self.records if r.demoted})

    def by_site(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            d = out.setdefault(r.site, {"mults": 0, "square_mults": 0,
                                        "demoted_mults": 0})
            d["mults"] += r.mults
            if r.mode in SQUARE_MODES:
                d["square_mults"] += r.mults
            if r.demoted:
                d["demoted_mults"] += r.mults
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "total_mults": self.total_mults,
            "multiplies_replaced_by_squares": self.multiplies_replaced,
            "fraction_square": self.fraction_square,
            "bwd_mults": self.bwd_mults,
            "fraction_square_bwd": self.fraction_square_bwd,
            "fraction_demoted": self.fraction_demoted,
            "demoted_sites": self.demoted_sites(),
            "by_site": self.by_site(),
        }

    def publish(self, registry) -> None:
        """Publish this audit into a
        :class:`repro_torch.obs.metrics.MetricsRegistry` as ``counting_*``
        gauges, beside the serving counters of the same run."""
        from repro_torch.obs.metrics import publish_contraction_audit
        publish_contraction_audit(self.summary(), registry)


_COUNTERS: List[ContractionCounter] = []
_SCALES: List[int] = [1]
# Depth of rematerialising recomputes in progress.  A module global, not a
# thread-local: on CUDA autograd runs the recompute in its own device
# thread while the caller's thread waits in ``backward``.
_RECOMPUTE_DEPTH = [0]


@contextlib.contextmanager
def track_contractions(allow_empty: bool = False):
    """Open a :class:`ContractionCounter` for the enclosed region.

    Every :func:`repro_torch.core.einsum.fs_einsum` executed inside notes
    its ``B*M*K*N`` multiply volume and served mode.  A region that
    closes with no records warns (:class:`EmptyAuditWarning`) unless
    ``allow_empty``.

    >>> import torch
    >>> from repro_torch.core.einsum import fs_einsum
    >>> with track_contractions() as ctr:
    ...     _ = fs_einsum("mk,kn->mn", torch.ones(4, 8), torch.ones(8, 2),
    ...                   mode="square_virtual", site="ffn")
    >>> ctr.multiplies_replaced        # 4 * 8 * 2 multiplies, one square each
    64
    >>> ctr.fraction_square
    1.0
    >>> ctr.by_site()["ffn"]["mults"]
    64
    """
    ctr = ContractionCounter()
    _COUNTERS.append(ctr)
    try:
        yield ctr
    finally:
        _COUNTERS.remove(ctr)
        if not ctr.records and not allow_empty:
            warnings.warn(
                "track_contractions region closed with no contraction "
                "records: nothing in it reached fs_einsum, so this audit "
                "would report fraction_square == 0.  Pass allow_empty=True "
                "if this is expected.",
                EmptyAuditWarning, stacklevel=3)


@contextlib.contextmanager
def count_scale(n: int):
    """Multiply contraction notes by ``n`` inside the region (one call
    standing for ``n`` executions)."""
    _SCALES.append(_SCALES[-1] * int(n))
    try:
        yield
    finally:
        _SCALES.pop()


@contextlib.contextmanager
def recomputing():
    """Mark the enclosed region as the recompute of a rematerialised one:
    contraction notes (eager and runtime) are dropped inside it."""
    _RECOMPUTE_DEPTH[0] += 1
    try:
        yield
    finally:
        _RECOMPUTE_DEPTH[0] -= 1


def remat(fn):
    """``fn`` under ``torch.utils.checkpoint.checkpoint(use_reentrant=
    False)``, the counterpart of ``jax.checkpoint``: its activations are
    recomputed in the backward, and that recompute notes no contraction
    (:func:`recomputing`).  Outside grad mode, or when no tensor argument
    requires grad (serving), ``fn`` just runs.  Under a CUDA graph capture
    (the captured train step) the checkpoint's save and restore of the
    CUDA RNG state are captured with it, which torch permits; no op of a
    train step draws random numbers, so there is nothing they change."""
    import torch
    from torch.utils import checkpoint

    def run(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)):
            return fn(*args)
        calls = [0]

        def body(*a):
            calls[0] += 1
            if calls[0] == 1:
                return fn(*a)
            with recomputing():
                return fn(*a)

        return checkpoint.checkpoint(body, *args, use_reentrant=False)

    return run


def note_contraction(*, site: str, spec: str, mode: str, mults: int,
                     demoted: bool = False) -> None:
    """Record one contraction into every open counter (no-op otherwise,
    and while a capture records: a capture executes nothing; no-op inside
    a rematerialising recompute too, :func:`recomputing`).

    ``demoted=True`` marks a contraction that would have been square-routed
    but was served standard because its route-health breaker tripped
    (``mode`` is then the served mode, ``"standard"``).
    """
    if not _COUNTERS or _RECOMPUTE_DEPTH[0]:
        return
    scaled = int(mults) * _SCALES[-1]
    for ctr in _COUNTERS:
        ctr.record(site or "einsum", spec, mode, scaled, demoted)


# --------------------------------------------------------------------------
# Compiled contraction accounting
#
# A CUDA graph replay runs no Python, so the notes above cannot see it.
# While ``compiled_audit`` is enabled AT CAPTURE TIME, the dispatcher also
# emits a runtime note into the capture's ledger (core/graphs.py), and
# every replay tallies it into the counters ``track_compiled_contractions``
# opened (no ``count_scale``: a replay is one execution).
# --------------------------------------------------------------------------

_RUNTIME_COUNTERS: List[ContractionCounter] = []
_COMPILED_AUDIT_STACK: List[bool] = []


def compiled_audit_enabled() -> bool:
    """Whether the dispatcher emits runtime notes into captures (innermost
    :func:`compiled_audit` region, else ``$REPRO_COMPILED_AUDIT=1``).
    Consulted at capture time only."""
    if _COMPILED_AUDIT_STACK:
        return _COMPILED_AUDIT_STACK[-1]
    return os.environ.get("REPRO_COMPILED_AUDIT", "") == "1"


@contextlib.contextmanager
def compiled_audit(enabled: bool = True):
    """Scope runtime-note emission.  Must cover the call that CAPTURES: the
    notes are part of a graph's ledger, so enabling the audit after the
    capture changes nothing (and disabling it later does not take notes
    out of a captured ledger)."""
    _COMPILED_AUDIT_STACK.append(bool(enabled))
    try:
        yield
    finally:
        _COMPILED_AUDIT_STACK.pop()


def land_runtime_note(site: str, spec: str, mode: str, mults: int,
                      demoted: bool = False) -> None:
    """Tally one executed runtime note into every open
    :func:`track_compiled_contractions` counter (a graph's ledger calls
    this at each replay)."""
    for ctr in _RUNTIME_COUNTERS:
        ctr.record(site, spec, mode, mults, demoted)


def emit_runtime_note(*, site: str, spec: str, mode: str, mults: int,
                      demoted: bool = False) -> None:
    """Record one contraction note into the capture's ledger, so that each
    replay of the graph tallies it.  Outside a capture it tallies at once,
    as a note of an eager execution; a capture without a ledger (not made
    by :class:`~repro_torch.core.graphs.CapturedCall`) cannot replay it
    and raises."""
    from repro_torch.core import graphs           # lazy: import cycle
    if _RECOMPUTE_DEPTH[0]:
        return
    note = (site or "einsum", spec, mode, int(mults), bool(demoted))
    ledger = graphs.current_ledger()
    if ledger is not None:
        ledger.notes.append(note)
    elif graphs.capturing():
        raise graphs.CaptureError(
            "a compiled-audit note under a CUDA graph capture that no "
            "ledger records: capture through repro_torch.core.graphs."
            "CapturedCall")
    else:
        land_runtime_note(*note)


@contextlib.contextmanager
def track_compiled_contractions():
    """Counter over the runtime notes of the graph replays made inside the
    region.

    The runtime complement of :func:`track_contractions`: a replay of a
    graph captured under :func:`compiled_audit` tallies its contraction
    mix here, where the eager counter sees nothing (and warns
    :class:`EmptyAuditWarning`).  Notes land when the replay is issued on
    the host, so the counter is complete when the region closes.
    """
    ctr = ContractionCounter()
    _RUNTIME_COUNTERS.append(ctr)
    try:
        yield ctr
    finally:
        _RUNTIME_COUNTERS.remove(ctr)
