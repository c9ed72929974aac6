"""Op-level cost analyzer (the dry run's "profiler"): the PyTorch port's
counterpart of ``repro/roofline/hlo_analysis.py``.

The JAX analyzer walks compiled per-device HLO text and multiplies each
while body by its trip count.  Here the step runs eagerly under a
``TorchDispatchMode`` that sees every aten op as it executes, so a Python
loop is counted once a trip and there is no trip count to recover.  It
accumulates :class:`OpCost` with ``HloCost``'s fields and meanings:

- ``dot_flops``: matmul-unit FLOPs (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions: 2 x output x contraction), plus the work each
  square-kernel launch replaces (2·m·n·k for K1);
- ``elem_flops``: elementwise ops (1 an output element) and reductions (1
  an input element);
- ``bytes``: what eager torch moves: every op that is not a view
  materialises its output, also in a CUDA-graph replay, so each moves its
  tensor operands and its output (a gather or a slice read moves twice its
  output, a scatter or a slice write twice its update, as JAX counts
  them);
- ``bytes_lb``: the same without elementwise ops and reductions (JAX's
  lower bound: contraction operands and outputs, gathers, scatters,
  copies, collectives); a square kernel's bytes count in both;
- ``collectives``: bytes by kind that the port's ``torch.distributed``
  calls move (:mod:`repro_torch.distributed.collectives` notes each; on an
  abstract mesh nothing is sent and the bytes are still counted), each
  also counted twice in ``bytes`` and ``bytes_lb`` as JAX does;
- ``by_scope``: ``dot_flops`` by aten op or kernel; ``bytes_by``: bytes by
  aten op or kernel.

Beyond ``HloCost``: the square kernels' launches
(:mod:`repro_torch.kernels.meta` records each launch a wrapper makes on
``meta`` tensors) give ``square_terms`` (m·n·k for K1), ``fp32_slots`` and
``int32_slots`` (from ``core/cost_model.py``'s launch costs: an int path's
slots are INT32, which an sm_90 SM issues at half the FP32 rate) and
``launches`` by kernel.  ``peak_bytes`` is the largest total of the
storages made inside the analysis that were alive at once.

The analyzer runs on any device; on ``meta`` tensors nothing is computed
or allocated, which is how :mod:`repro_torch.launch.dryrun` prices a step
at published width.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import meta

__all__ = ["OpCost", "OpAnalyzer", "analyze"]

aten = torch.ops.aten

_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default, aten.addbmm.default, aten.mv.default,
         aten.dot.default, aten.convolution.default}
# ops that allocate: a live storage, no bytes, no flops
_ALLOCS = {aten.empty.memory_format, aten.empty_like.default,
           aten.empty_strided.default}
# ops that only describe: no bytes, no flops
_FREE = {aten.lift_fresh.default,
         aten.detach.default, aten._unsafe_view.default, aten.alias.default,
         aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
         aten.is_nonzero.default, aten._local_scalar_dense.default,
         aten.set_.source_Storage_storage_offset}
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
            aten.embedding.default, aten.take.default}
_SCATTERS = {aten.index_put_.default, aten.index_put.default,
             aten._index_put_impl_.default, aten.scatter.src,
             aten.scatter_.src, aten.scatter.value, aten.scatter_.value,
             aten.scatter_add.default, aten.scatter_add_.default,
             aten.index_add.default, aten.index_add_.default,
             aten.index_copy.default, aten.index_copy_.default,
             aten.slice_scatter.default, aten.select_scatter.default,
             aten.copy_.default}
# dtype conversion is JAX's elementwise ``convert``
_CONVERTS = {aten._to_copy.default}
# reductions by name (the ``reduction`` tag is missing from older torch
# releases; this is its set of packets), so the counts do not depend on
# the release
_REDUCTIONS = {"all", "amax", "amin", "aminmax", "any", "argmax", "argmin",
               "count_nonzero", "linalg_vector_norm", "logsumexp", "max",
               "mean", "min", "nansum", "norm", "prod", "std", "std_mean",
               "sum", "var", "var_mean"}


def _add(d: Dict[str, float], o: Dict[str, float], n: float = 1.0):
    out = dict(d)
    for k, v in o.items():
        out[k] = out.get(k, 0.0) + v * n
    return out


@dataclasses.dataclass
class OpCost:
    dot_flops: float = 0.0
    elem_flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_scope: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_lb: float = 0.0
    square_terms: float = 0.0
    kernel_flops: float = 0.0     # the part of dot_flops the kernels do
    fp32_slots: float = 0.0
    int32_slots: float = 0.0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    def __add__(self, o: "OpCost") -> "OpCost":
        return OpCost(self.dot_flops + o.dot_flops,
                      self.elem_flops + o.elem_flops, self.bytes + o.bytes,
                      _add(self.collectives, o.collectives),
                      _add(self.by_scope, o.by_scope),
                      _add(self.bytes_by, o.bytes_by),
                      self.bytes_lb + o.bytes_lb,
                      self.square_terms + o.square_terms,
                      self.kernel_flops + o.kernel_flops,
                      self.fp32_slots + o.fp32_slots,
                      self.int32_slots + o.int32_slots,
                      {k: int(v) for k, v in
                       _add(self.launches, o.launches).items()},
                      max(self.peak_bytes, o.peak_bytes))

    def scaled(self, n: float) -> "OpCost":
        """``n`` runs of the analysed work, one after another (the peak
        stays one run's)."""
        return OpCost(self.dot_flops * n, self.elem_flops * n,
                      self.bytes * n, _add({}, self.collectives, n),
                      _add({}, self.by_scope, n), _add({}, self.bytes_by, n),
                      self.bytes_lb * n, self.square_terms * n,
                      self.kernel_flops * n, self.fp32_slots * n,
                      self.int32_slots * n,
                      {k: int(v * n) for k, v in self.launches.items()},
                      self.peak_bytes)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def to_dict(self) -> Dict[str, Any]:
        return {"dot_flops": self.dot_flops, "elem_flops": self.elem_flops,
                "bytes": self.bytes, "bytes_lb": self.bytes_lb,
                "collectives": dict(self.collectives),
                "collective_bytes": self.collective_bytes,
                "square_terms": self.square_terms,
                "kernel_flops": self.kernel_flops,
                "fp32_slots": self.fp32_slots,
                "int32_slots": self.int32_slots,
                "launches": dict(self.launches),
                "peak_bytes": self.peak_bytes}


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors among ``tree``'s leaves (tuples, lists and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


_FREE_OP, _ALLOC, _DOT, _GATHER, _SCATTER, _ELEM, _REDUCE, _OTHER = range(8)
_KINDS: Dict[Any, Tuple[int, bool, str]] = {}


def _kind(func) -> Tuple[int, bool, str]:
    """(category, in place, name) of an aten op, worked out once."""
    got = _KINDS.get(func)
    if got is not None:
        return got
    if func in _ALLOCS:
        cat = _ALLOC
    elif func in _FREE or getattr(func, "is_view", False):
        cat = _FREE_OP
    elif func in _DOTS:
        cat = _DOT
    elif func in _GATHERS:
        cat = _GATHER
    elif func in _SCATTERS:
        cat = _SCATTER
    elif torch.Tag.pointwise in func.tags or func in _CONVERTS:
        cat = _ELEM
    elif func.overloadpacket.__name__ in _REDUCTIONS:
        cat = _REDUCE
    else:
        cat = _OTHER
    # an in-place op's schema name ends in "_" (every op the ``inplace``
    # tag marks does, and older releases lack the tag)
    inplace = func._schema.name.endswith("_")
    got = _KINDS[func] = (cat, inplace, str(func.overloadpacket.__name__))
    return got


def _dot_flops(func, args, out: torch.Tensor) -> float:
    if func is aten.convolution.default:
        w = args[1]                       # (cout, cin / groups, taps...)
        return 2.0 * out.numel() * w.shape[1] * math.prod(w.shape[2:])
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default,
                            aten.addbmm.default) else args[0]
    k = a.shape[-1]
    if func is aten.addbmm.default:
        return 2.0 * out.numel() * k * a.shape[0]
    return 2.0 * out.numel() * k


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.memory_format, torch.layout)


def _key(x):
    """A hashable key of an op argument's metadata; raises TypeError for
    an argument the memo cannot key (it then runs the op)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("only meta tensors are memoised")
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if isinstance(x, _SCALARS):
        return x
    raise TypeError(f"unkeyed argument {type(x).__name__}")


# (op, argument metadata) -> the output's (shape, stride, dtype) on meta:
# a layer's ops repeat with the same metadata, and a meta op's output
# depends on nothing else, so the dry run computes each such op once
_META_MEMO: Dict[Any, Any] = {}


def _meta_call(func, args, kwargs):
    """``func(*args, **kwargs)`` on meta tensors, from the memo where it
    has the op at this metadata (fresh outputs of a non-view, out-of-place
    op only)."""
    try:
        key = (func, _key(args), _key(kwargs))
    except TypeError:
        return func(*args, **kwargs)
    got = _META_MEMO.get(key)
    if got is not None:
        single, metas = got
        outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
                for s, st, dt in metas]
        return outs[0] if single else tuple(outs)
    out = func(*args, **kwargs)
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if isinstance(outs, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in outs):
        _META_MEMO[key] = (single, [(tuple(t.shape), t.stride(), t.dtype)
                                    for t in outs])
    return out


class OpAnalyzer(TorchDispatchMode):
    """Context manager: every aten op run inside (on any device) and every
    square-kernel launch and collective is priced into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._live = 0.0
        self._rec = None
        self._records = None
        self._unlisten = None

    # ---- live storages ----
    def _alloc(self, t: torch.Tensor) -> None:
        nb = _nbytes(t)
        if nb == 0:
            return
        self._live += nb
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        weakref.finalize(t, self._free, nb)

    def _free(self, nb: float) -> None:
        self._live -= nb

    # ---- accounting ----
    def _count(self, key: str, bytes_: float, lb: bool) -> None:
        c = self.cost
        c.bytes += bytes_
        c.bytes_by[key] = c.bytes_by.get(key, 0.0) + bytes_
        if lb:
            c.bytes_lb += bytes_

    def _collective(self, kind: str, nbytes: int) -> None:
        c = self.cost
        c.collectives[kind] = c.collectives.get(kind, 0.0) + nbytes
        self._count(kind, 2.0 * nbytes, True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        cat, inplace, key = _kind(func)
        if cat not in (_FREE_OP, _ALLOC) and not inplace:
            out = _meta_call(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if cat == _FREE_OP:
            return out
        if cat == _ALLOC:
            self._alloc(out)
            return out
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        outs = _tensors(out)
        if not inplace:
            for t in outs:
                if not any(t is i for i in ins):
                    self._alloc(t)
        c = self.cost
        out_b = sum(_nbytes(t) for t in outs)
        if cat == _GATHER:
            self._count(key, 2.0 * out_b, True)
            return out
        if cat == _SCATTER:
            upd = _nbytes(ins[1] if func is aten.copy_.default else ins[-1])
            self._count(key, 2.0 * min(upd, _nbytes(ins[0])), True)
            return out
        in_b = sum(_nbytes(t) for t in ins)
        if cat == _DOT:
            f = _dot_flops(func, args, outs[0])
            c.dot_flops += f
            c.by_scope[key] = c.by_scope.get(key, 0.0) + f
            self._count(key, in_b + out_b, True)
        elif cat == _ELEM:
            c.elem_flops += sum(t.numel() for t in outs)
            self._count(key, in_b + out_b, False)
        elif cat == _REDUCE:
            c.elem_flops += max((t.numel() for t in ins), default=0)
            self._count(key, in_b + out_b, False)
        else:
            self._count(key, in_b + out_b, True)
        return out

    def __enter__(self):
        self._rec = meta.recording()
        self._records = self._rec.__enter__()
        self._unlisten = coll.listen(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._unlisten()
        self._rec.__exit__(*exc)
        c = self.cost
        for r in self._records:
            c.dot_flops += r.flops
            c.kernel_flops += r.flops
            c.by_scope[r.kernel] = c.by_scope.get(r.kernel, 0.0) + r.flops
            c.square_terms += r.terms
            if r.int_path:
                c.int32_slots += r.cost.fp32_slots
            else:
                c.fp32_slots += r.cost.fp32_slots
            self._count(r.kernel, r.cost.bytes, True)
            c.launches[r.kernel] = c.launches.get(r.kernel, 0) + 1
        return out


def analyze(fn, *args, **kwargs) -> OpCost:
    """The :class:`OpCost` of one call ``fn(*args, **kwargs)``."""
    with OpAnalyzer() as an:
        fn(*args, **kwargs)
    return an.cost
