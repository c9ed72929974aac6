"""Model configuration dataclasses: the PyTorch port of
``repro/configs/base.py``.

``ModelConfig`` is the same record as in the JAX package, field for field,
so a configuration means the same in both.  ``ContractionPolicy`` pins
individual contraction sites to a mode: forward sites, and the backward
sites ``<site>.bwd_x``/``<site>.bwd_w`` the ``fs_einsum`` VJP notes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "pad_vocab", "ContractionPolicy",
           "CONTRACTION_SITES", "GRAD_SITE_SUFFIXES", "SQUARE_GEMMS_POLICY"]


def pad_vocab(v: int, mult: int = 256) -> int:
    return v + (-v) % mult


CONTRACTION_SITES = (
    "dense",            # generic dense_apply fallback
    "attn_qkv",         # attention input projections
    "attn_out",         # attention output projection
    "attn_scores",      # q @ k^T (softmax path)
    "attn_pv",          # probs @ v (softmax path)
    "ffn",              # dense FFN up/gate/down
    "moe_router",       # MoE router logits
    "moe_expert",       # batched expert GEMMs
    "logits",           # LM head / vocab GEMM
    "loss",             # chunked-xent vocab GEMM
    "recurrent_gates",  # xLSTM / RG-LRU gate projections
    "recurrent_mix",    # recurrent state-mix contractions
    "recurrent_proj",   # recurrent block dense projections
    "attn_paged",       # fused paged-attention read (serving decode path)
)

# The fs_einsum VJP re-enters the dispatcher for both backward contractions
# under derived site names: ``<site>.bwd_x`` (dL/dx) and ``<site>.bwd_w``
# (dL/dW).  A policy may pin them apart from the forward site; an unpinned
# backward site inherits the forward site's pin (``lookup``).
GRAD_SITE_SUFFIXES = (".bwd_x", ".bwd_w")


def _valid_site(site: str) -> bool:
    if site in CONTRACTION_SITES:
        return True
    return any(site.endswith(suf) and site[:-len(suf)] in CONTRACTION_SITES
               for suf in GRAD_SITE_SUFFIXES)


@dataclasses.dataclass(frozen=True)
class ContractionPolicy:
    """Per-site contraction-mode overrides.

    Resolution: ``overrides[site]`` if present, else (for a backward
    site) the forward site's override, else ``default`` if set, else the
    caller's ``mode`` (models pass ``cfg.matmul_mode``).  Backward sites
    are pinned through a dict, since dots are not identifier characters.

    >>> p = ContractionPolicy.of(default="square_virtual",
    ...                          attn_scores="standard")
    >>> p.lookup("attn_scores"), p.lookup("ffn")
    ('standard', 'square_virtual')
    >>> p.lookup("attn_scores.bwd_x")    # backward inherits the fwd pin
    'standard'
    >>> q = ContractionPolicy.of(**{"ffn.bwd_w": "standard"})
    >>> q.lookup("ffn.bwd_w"), q.lookup("ffn.bwd_x"), q.lookup("ffn")
    ('standard', None, None)
    """
    overrides: Tuple[Tuple[str, str], ...] = ()
    default: Optional[str] = None

    @classmethod
    def of(cls, default: Optional[str] = None,
           **sites: str) -> "ContractionPolicy":
        from repro_torch.core.matmul import MODES
        bad = sorted(s for s in sites if not _valid_site(s))
        if bad:
            raise ValueError(f"unknown contraction site(s) {bad}; expected "
                             f"names from {CONTRACTION_SITES}, optionally "
                             f"suffixed with {GRAD_SITE_SUFFIXES}")
        for site, m in sites.items():
            if m not in MODES:
                raise ValueError(f"unknown mode {m!r} for site {site!r}; "
                                 f"expected one of {MODES}")
        if default is not None and default not in MODES:
            raise ValueError(f"unknown default mode {default!r}; expected "
                             f"one of {MODES}")
        return cls(tuple(sorted(sites.items())), default)

    def lookup(self, site: Optional[str]) -> Optional[str]:
        for s, m in self.overrides:
            if s == site:
                return m
        if site is not None and site.endswith(GRAD_SITE_SUFFIXES):
            base = site.rsplit(".", 1)[0]
            for s, m in self.overrides:
                if s == base:
                    return m
        return self.default


# Square-form GEMMs wherever the operands are weights/activations; the
# attention softmax path (scores, probs x values) stays on the multiplier
# baseline.
SQUARE_GEMMS_POLICY = ContractionPolicy.of(
    attn_scores="standard", attn_pv="standard")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    activation: str = "swiglu"       # ffn: swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window attention size
    attn_bias: bool = False
    ffn_bias: bool = False
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25
    # --- layer pattern (cycled): attn | moe | mlstm | slstm | rglru | lattn ---
    block_pattern: Tuple[str, ...] = ("attn",)
    # --- recurrent (rg-lru / conv) ---
    rnn_width: int = 0
    conv_width: int = 4
    local_window: int = 2048
    # --- xlstm ---
    inner_factor: float = 2.0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- modality frontend stubs ---
    prefix_tokens: int = 0
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    matmul_mode: str = "standard"
    contraction_policy: Optional[ContractionPolicy] = None
    scan_layers: bool = True         # JAX layout of the params (convert.py)
    remat: str = "block"
    loss_chunk: int = 2048
    attn_chunk_q: int = 2048
    attn_chunk_kv: int = 1024
    attn_block_skip: bool = False
    attn_p_bf16: bool = False
    tp_bf16_reduce: bool = False
    attn_fold_q: bool = False
    max_seq: int = 524288
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True if decode-time state is O(1) in context length (a sliding
        window counts: its cache is window-bounded)."""
        kinds = set(self.layer_kinds)
        if "attn" in kinds or "moe" in kinds:
            return self.window is not None
        return True                  # recurrent / local-attention only

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.is_subquadratic
        return True

    def reduced(self) -> "ModelConfig":
        """Smoke-test config of the same family (the JAX package's rule)."""
        pat_len = len(self.block_pattern)
        n_layers = max(pat_len, 2 if pat_len == 1 else pat_len)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=4 if self.n_experts else 0,
            topk=2 if self.topk else 0,
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            rnn_width=64 if self.rnn_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            prefix_tokens=4 if self.prefix_tokens else 0,
            window=min(self.window, 64) if self.window else None,
            local_window=32,
            dtype="float32",
            loss_chunk=64,
            attn_chunk_q=32,
            attn_chunk_kv=32,
            max_seq=256,
            scan_layers=self.scan_layers,
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
