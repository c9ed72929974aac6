"""The LM: the PyTorch port of ``repro/models/lm.py`` (the full-sequence
forward and prefill, dense and paged decode, logits, prepared weights) for
decoder LMs, the whisper-style encoder-decoder and the VLM-prefixed LM.

``LM`` is an ``nn.Module`` whose layers are a Python loop over a
``ModuleList`` (the JAX package scans stacked layers; the port has no scan
stack).  The functional entry points take a params tree, as in the JAX
package: :meth:`LM.tree` is the module's own weights (serving weights,
``requires_grad=False``), :meth:`LM.train_params` a copy of them as plain
tensors for the functional train step, and :meth:`LM.prepare_params`
returns the tree with every attention, FFN and expert weight -- of every
layer -- replaced by a :class:`~repro_torch.core.prepared.PreparedOperand`
(a recurrent block's ``mix`` weights stay raw, as in JAX).

An encoder-decoder arch (``cfg.encoder_layers``, whisper) also holds an
``encoder``: ``encoder_layers`` non-causal ``attn`` blocks over the
request's precomputed frame embeddings (``batch["frames"]``; the conv
frontend is a stub, as in JAX) and a norm.  Its decoder layers are
``xdec`` blocks (an ``attn`` of the pattern becomes ``xdec``), whose
cross-attention reads the encoder's output; their decode caches carry the
encoder's K/V per slot.

A prefix-token arch (``cfg.prefix_tokens``, paligemma) puts the request's
precomputed patch embeddings (``batch["patches"]``, (B, P, D); the SigLIP
frontend is a stub, as in JAX) ahead of the token embeddings in the
full-sequence forward, so the prefix holds positions ``0..P-1`` and the
prompt ``P..P+S-1``; a decode step embeds its token alone, at its
absolute position.  Such an arch serves through the dense ``Server``.

Under autograd, ``cfg.remat == "block"`` rematerialises each block in the
backward (``torch.utils.checkpoint`` through
:func:`repro_torch.core.counting.remat`, where JAX wraps its scan body in
``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from repro_torch.core import counting
from repro_torch.core.einsum import fs_einsum
from repro_torch.core.prepared import prepare_operand
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.layers import basic
from repro_torch.layers.param import (abstract_tree, count_params,
                                      init_module, torch_dtype)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk

__all__ = ["LM", "build_model", "decoder_kinds"]


def _check_supported(cfg) -> None:
    if any(k not in blk.KINDS for k in cfg.layer_kinds):
        raise NotImplementedError(
            f"arch {cfg.name!r} (family {cfg.family!r}, blocks "
            f"{sorted(set(cfg.layer_kinds))}) is not ported: this port "
            f"builds decoder LMs of attention, MoE, local-attention and "
            f"recurrent (RG-LRU, mLSTM, sLSTM) blocks, encoder-decoder LMs "
            f"(whisper) and prefix-token LMs (paligemma)")


def decoder_kinds(cfg) -> tuple:
    """The block kind of each decoder layer: ``cfg.layer_kinds``, with
    ``attn`` as ``xdec`` in an encoder-decoder arch (JAX's ``dec_kind``)."""
    if not cfg.encoder_layers:
        return cfg.layer_kinds
    return tuple("xdec" if k == "attn" else k for k in cfg.layer_kinds)


def _as_tree(m: nn.Module):
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    if isinstance(m, nn.ModuleDict):
        return {k: _as_tree(v) for k, v in m.items()}
    raise TypeError(f"unexpected module {type(m).__name__} in a param tree")


class LM(nn.Module):
    """Decoder LM (attention, MoE, local-attention and recurrent blocks),
    encoder-decoder LM, or prefix-token LM, with tied embeddings."""

    def __init__(self, cfg, *, device: torch.device, seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        dt = torch_dtype(cfg.dtype)
        norm = (basic.layernorm_spec if cfg.norm == "layernorm"
                else basic.rmsnorm_spec)
        self.embed = init_module(
            basic.embed_spec(cfg.padded_vocab, cfg.d_model, dt), gen, device)
        self.final_norm = init_module(norm(cfg.d_model), gen, device)
        self.layers = nn.ModuleList(
            init_module(blk.block_spec(k, cfg), gen, device)
            for k in self.kinds)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleDict({
                "layers": nn.ModuleList(
                    init_module(blk.block_spec("attn", cfg), gen, device)
                    for _ in range(cfg.encoder_layers)),
                "norm": init_module(norm(cfg.d_model), gen, device)})

    @property
    def kinds(self) -> tuple:
        """Each decoder layer's block kind (:func:`decoder_kinds`)."""
        return decoder_kinds(self.cfg)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ------------------------------------------------------------ params
    def spec(self) -> Dict[str, Any]:
        """The :class:`~repro_torch.layers.param.ParamSpec` tree of the
        weights, in :meth:`tree`'s layout: a list of per-layer subtrees
        where JAX stacks the layers of a period (so each tensor's axes are
        JAX's without the leading ``layers`` axis)."""
        cfg = self.cfg
        norm = (basic.layernorm_spec if cfg.norm == "layernorm"
                else basic.rmsnorm_spec)
        s = {"embed": basic.embed_spec(cfg.padded_vocab, cfg.d_model,
                                       torch_dtype(cfg.dtype)),
             "final_norm": norm(cfg.d_model),
             "layers": [blk.block_spec(k, cfg) for k in self.kinds]}
        if cfg.encoder_layers:
            s["encoder"] = {"layers": [blk.block_spec("attn", cfg)
                                       for _ in range(cfg.encoder_layers)],
                            "norm": norm(cfg.d_model)}
        return s

    def abstract_params(self) -> Dict[str, Any]:
        """The params tree as ``meta`` tensors (nothing allocated)."""
        return abstract_tree(self.spec())

    def n_params(self) -> int:
        return count_params(self.spec())

    def n_active_params(self) -> int:
        """Active params per token (MoE discounts inactive experts)."""
        cfg = self.cfg
        total = self.n_params()
        if not cfg.n_experts:
            return total
        expert_p = 3 * cfg.d_model * cfg.d_ff     # gate+up+down per expert
        per_layer_inactive = (cfg.n_experts - cfg.topk) * expert_p
        n_moe_layers = sum(1 for k in cfg.layer_kinds if k == "moe")
        return total - n_moe_layers * per_layer_inactive

    def tree(self) -> Dict[str, Any]:
        """The module's weights as a params tree (with ``"encoder":
        {"layers": [...], "norm"}`` in an encoder-decoder arch)."""
        tree = {"embed": _as_tree(self.embed),
                "final_norm": _as_tree(self.final_norm),
                "layers": [_as_tree(layer) for layer in self.layers]}
        if self.cfg.encoder_layers:
            tree["encoder"] = {
                "layers": [_as_tree(p) for p in self.encoder["layers"]],
                "norm": _as_tree(self.encoder["norm"])}
        return tree

    def train_params(self) -> Dict[str, Any]:
        """A copy of the module's weights as plain tensors: the functional
        params tree the train step takes and AdamW returns anew (the
        module's own weights stay serving weights)."""
        return tree_map(lambda p: p.detach().clone(), self.tree())

    def prepare_params(self, params: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        """Weight-stationary inference params (paper §4-§5): every
        attention projection (cross-attention's too) and FFN weight of
        every layer, the encoder's included -- of a MoE block the router
        (site ``moe_router``) and the three batched ``(E, K, N)`` expert
        stacks (``moe_expert``) -- and the transposed vocab table
        (``logits_prep``), prepared once: widened, ``Sb`` precomputed.  A
        recurrent block's ``mix`` subtree stays raw, as in the JAX
        package."""
        params = params if params is not None else self.tree()
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads

        def prep_attn(p):
            a = {k: dict(v) for k, v in p.items()}
            for nm, nh in (("wq", H), ("wk", KV), ("wv", KV)):
                w = a[nm]["w"]
                a[nm]["w"] = prepare_operand(w.reshape(w.shape[0], nh * hd),
                                             site="attn_qkv")
            wo = a["wo"]["w"]
            a["wo"]["w"] = prepare_operand(wo.reshape(H * hd, wo.shape[-1]),
                                           site="attn_out")
            return a

        def prep_layer(p):
            q = dict(p)
            for key in ("attn", "xattn"):
                if key in p:
                    q[key] = prep_attn(p[key])
            if "ffn" in p and "router" in p["ffn"]:
                q["ffn"] = {k: dict(v, w=prepare_operand(
                    v["w"], site="moe_router" if k == "router"
                    else "moe_expert")) for k, v in p["ffn"].items()}
            elif "ffn" in p:
                q["ffn"] = {k: dict(v, w=prepare_operand(v["w"], site="ffn"))
                            for k, v in p["ffn"].items()}
            return q

        new = dict(params)
        new["layers"] = [prep_layer(p) for p in params["layers"]]
        if "encoder" in params:
            new["encoder"] = dict(params["encoder"], layers=[
                prep_layer(p) for p in params["encoder"]["layers"]])
        new["logits_prep"] = prepare_operand(
            params["embed"]["table"].float(), transpose=True, site="logits")
        return new

    # ------------------------------------------------------- embedding
    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """The scaled token embeddings of ``tokens``, in the config's
        dtype (a decode step's input)."""
        cfg = self.cfg
        x = basic.embed_apply(params["embed"], tokens)
        # the JAX package multiplies by sqrt(d) rounded to the table's dtype
        scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
        return (x * scale).to(torch_dtype(cfg.dtype))

    def _embed_in(self, params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        """The full-sequence input: ``batch["tokens"]``' scaled embeddings,
        after a prefix arch's ``batch["patches"]`` (cast to the
        activation dtype, not scaled), as JAX's ``_embed_in``."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.cfg.prefix_tokens:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _norm(self, p, x: torch.Tensor) -> torch.Tensor:
        norm = (basic.layernorm_apply if self.cfg.norm == "layernorm"
                else basic.rmsnorm_apply)
        return norm(p, x)

    def _final_norm(self, params, x: torch.Tensor) -> torch.Tensor:
        return self._norm(params["final_norm"], x)

    def _blocks(self, kinds, layers, x, ctx, collect: Optional[list]):
        """``x`` through the blocks ``layers`` of ``kinds``; each layer's
        cache seed goes to ``collect`` (prefill), else under autograd
        ``cfg.remat == "block"`` rematerialises each block.  Returns ``(x,
        the summed aux loss)``."""
        aux_total = torch.zeros((), device=x.device)
        for kind, p in zip(kinds, layers):
            if self.cfg.remat != "none" and collect is None:
                x, aux = counting.remat(
                    lambda x, kind=kind, p=p:
                    blk.block_forward(kind, p, x, ctx)[::2])(x)
            else:
                x, seed, aux = blk.block_forward(kind, p, x, ctx)
                if collect is not None:
                    collect.append(seed)
            aux_total = aux_total + aux
        return x, aux_total

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over precomputed frame embeddings ``frames`` (B, T,
        D) (the conv frontend is a stub, as in JAX): cast to the config's
        dtype, ``encoder_layers`` non-causal ``attn`` blocks at positions
        ``arange(T)``, then the encoder's norm."""
        cfg = self.cfg
        x = frames.to(torch_dtype(cfg.dtype))
        ctx = {"cfg": cfg, "mode": cfg.matmul_mode,
               "policy": cfg.contraction_policy,
               "positions": torch.arange(x.shape[1], device=x.device),
               "causal": False}
        enc = params["encoder"]
        x, _ = self._blocks(("attn",) * len(enc["layers"]), enc["layers"],
                            x, ctx, None)
        return self._norm(enc["norm"], x)

    # ----------------------------------------------------- full forward
    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                collect_cache: bool = False):
        """Teacher-forced full-sequence pass over ``batch["tokens"]``
        (B, S) -> ``(hidden (B, S, D), aux_loss, caches)``; an
        encoder-decoder arch first encodes ``batch["frames"]`` (B, T, D);
        a prefix arch's ``batch["patches"]`` (B, P, D) come first, so
        ``hidden`` is (B, P + S, D).
        With ``collect_cache`` (prefill), ``caches`` lists each layer's
        seed -- an attention layer's ``{"k", "v"}`` (an ``xdec`` layer's
        with its cross ``"xk"``, ``"xv"``), a recurrent layer's final
        state; otherwise it is empty."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        ctx = {"cfg": cfg, "mode": cfg.matmul_mode,
               "policy": cfg.contraction_policy, "positions": positions,
               "causal": True}
        if cfg.encoder_layers:
            enc = self.encode(params, batch["frames"])
            ctx["cross_x"] = enc
            ctx["cross_positions"] = torch.arange(enc.shape[1],
                                                  device=x.device)
        caches = [] if collect_cache else None
        x, aux_total = self._blocks(self.kinds, params["layers"], x, ctx,
                                    caches)
        return self._final_norm(params, x), aux_total, caches or []

    # ------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, cache_len: int
                   ) -> List[Dict[str, torch.Tensor]]:
        """One dense decode cache per layer: an attention layer's ``{"k",
        "v", "pos"}`` ring, ``cache_len`` long (the window under a sliding
        window), every position EMPTY_POS, an ``xdec`` layer's with zero
        ``"xk"``, ``"xv"`` of ``cfg.encoder_seq`` entries; a recurrent
        layer's initial state (zeros, the xLSTM stabilizers at -1e30)."""
        return [blk.block_init_cache(k, self.cfg, batch_size, cache_len,
                                     self.device,
                                     enc_len=self.cfg.encoder_seq)
                for k in self.kinds]

    def init_paged_cache(self, pool_slots: int) -> List[Dict[str, torch.Tensor]]:
        """One ``(pool_slots, KV, hd)`` K/V pool per layer, shared by every
        sequence through the engine's block tables.  Raises ValueError for
        an encoder-decoder arch, a prefix-token arch and an arch with a
        recurrent layer, which serve through the dense ``Server``, as the
        JAX package does."""
        if self.cfg.encoder_layers or self.cfg.prefix_tokens:
            raise ValueError(
                "paged serving supports plain decoder LMs; encoder-decoder "
                "and prefix-token archs use the dense reference Server")
        return [blk.block_init_paged_cache(k, self.cfg, pool_slots,
                                           self.device)
                for k in self.kinds]

    # ------------------------------------------------------ paged decode
    def decode_paged(self, params, cache, tokens: torch.Tensor,
                     positions: torch.Tensor, tables: torch.Tensor,
                     pos_pool: torch.Tensor, *, block_size: int
                     ) -> torch.Tensor:
        """One multi-token step against the paged cache; returns the
        final-normed hidden states (B, S, D).

        ``tokens``/``positions``: (B, S) int32, ``-1`` positions mark
        padding (written to the null block, never attended).  S = 1 is
        batched decode, S > 1 a prefill chunk.  ``tables``: (B, nb) int32.
        ``pos_pool`` (P,) and the per-layer pools in ``cache`` are updated
        IN PLACE (the JAX version returns new ones).
        """
        cfg = self.cfg
        phys = attn_mod.paged_slots(tables, positions, block_size)
        pos_pool[phys.reshape(-1)] = torch.where(
            positions >= 0, positions, attn_mod.EMPTY_POS).reshape(-1).to(
                pos_pool.dtype)
        x = self._embed_tokens(params, torch.clamp(tokens, min=0))
        ctx = {"cfg": cfg, "mode": cfg.matmul_mode,
               "policy": cfg.contraction_policy, "pos": positions,
               "paged": {"tables": tables, "pos_pool": pos_pool,
                         "phys": phys, "block_size": block_size}}
        for kind, p, c in zip(self.kinds, params["layers"], cache):
            x = blk.block_decode(kind, p, x, c, ctx)
        return self._final_norm(params, x)

    # ------------------------------------------------------ dense decode
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """One decode step against the dense cache.  ``tokens`` (B, 1),
        ``pos`` (B,) absolute.  The cache is updated IN PLACE -- K/V rings
        at each row's slot, recurrent states copied into their own tensors
        (the JAX version returns a new cache) -- so a captured step carries
        it from replay to replay; an ``xdec`` layer reads its slot's
        encoder K/V there.  Returns ``(logits (B, V), cache)``."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        ctx = {"cfg": cfg, "mode": cfg.matmul_mode,
               "policy": cfg.contraction_policy, "pos": pos}
        for kind, p, c in zip(self.kinds, params["layers"], cache):
            x = blk.block_decode(kind, p, x, c, ctx)
        x = self._final_norm(params, x)
        return self.logits(params, x)[:, 0], cache

    # ----------------------------------------------------------- prefill
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: int):
        """Process a prompt; returns ``(hidden (B, S, D), cache)`` with the
        cache ready for :meth:`decode_step` (a prefix arch's ``hidden`` and
        cache cover its P patches first: (B, P + S, D), and the next
        position is P + S).  When the prompt fills an
        attention layer's cache (S >= T, a sliding-window ring), its last T
        entries roll in at slot ``pos % T``; an ``xdec`` layer's encoder
        K/V and a recurrent layer's final state are copied in as they
        are."""
        hidden, _, seeds = self.forward(params, batch, collect_cache=True)
        cache = self.init_cache(hidden.shape[0], cache_len)
        dev = hidden.device
        for dst, seed in zip(cache, seeds):
            if "k" not in seed:                     # recurrent state
                for key, t in seed.items():
                    dst[key].copy_(t)
                continue
            S, T = seed["k"].shape[1], dst["k"].shape[1]
            if S >= T:
                ps = torch.arange(S - T, S, device=dev)
                idx = ps % T
                dst["k"][:, idx] = seed["k"][:, -T:]
                dst["v"][:, idx] = seed["v"][:, -T:]
                dst["pos"][:, idx] = ps.to(torch.int32)
            else:
                dst["k"][:, :S] = seed["k"]
                dst["v"][:, :S] = seed["v"]
                dst["pos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                                 device=dev)
            if "xk" in dst:
                dst["xk"].copy_(seed["xk"])
                dst["xv"].copy_(seed["xv"])
        return hidden, cache

    # ------------------------------------------------------------ logits
    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits (B, S, V) in f32; a ``logits_prep`` entry
        supplies the prepared vocab table."""
        cfg = self.cfg
        table = params.get("logits_prep")
        if table is None:
            table = params["embed"]["table"].float()
        return fs_einsum("bsd,vd->bsv", hidden.float(), table,
                         mode=cfg.matmul_mode, policy=cfg.contraction_policy,
                         site="logits")


def build_model(cfg, *, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> LM:
    """An LM with weights drawn from ``seed`` on ``device`` (default: CUDA,
    which must be present); on ``"meta"`` its weights are abstract
    (:meth:`LM.abstract_params`'s) and nothing is drawn."""
    return LM(cfg, device=resolve_device(device), seed=seed)
