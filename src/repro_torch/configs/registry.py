"""Architecture registry as data: the same configurations as
``repro/configs/registry.py``.  The port builds only plain dense attention
LMs so far (``models.lm.build_model``); the other families are listed for
the record and raise there.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config"]


paligemma_3b = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, activation="geglu", rope_theta=10000.0,
    prefix_tokens=256,              # SigLIP patch embeddings (stub frontend)
    attn_logit_softcap=0.0, tie_embeddings=True,
    source="arXiv:2407.07726; hf (gemma backbone, SigLIP stub)")

xlstm_350m = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=256, inner_factor=2.0,
    block_pattern=("mlstm",) * 7 + ("slstm",),    # xLSTM[7:1] placement
    source="arXiv:2405.04517 (sLSTM + mLSTM blocks)")

h2o_danube_3_4b = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab=32000, head_dim=120, activation="swiglu", window=4096,
    rope_theta=10000.0, source="arXiv:2401.16818 (llama+mistral mix, SWA)")

command_r_35b = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000, head_dim=128, activation="swiglu",
    rope_theta=8000000.0, attn_bias=False, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01 (GQA, no-bias)")

deepseek_7b = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400, head_dim=128, activation="swiglu",
    source="arXiv:2401.02954 (llama-arch, MHA)")

starcoder2_3b = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, head_dim=128, activation="gelu", window=4096,
    attn_bias=True, ffn_bias=True, norm="layernorm",
    rope_theta=999999.0, source="arXiv:2402.19173 (GQA kv=2, RoPE, SWA)")

whisper_large_v3 = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, head_dim=64, activation="gelu", norm="layernorm",
    attn_bias=True, ffn_bias=True,
    encoder_layers=32, encoder_seq=1500,     # conv frontend stubbed: frames in
    source="arXiv:2212.04356 (enc-dec; conv frontend stub per spec)")

moonshot_v1_16b_a3b = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128, activation="swiglu",
    n_experts=64, topk=6, block_pattern=("moe",),
    source="hf:moonshotai/Moonlight-16B-A3B (64e top-6)")

mixtral_8x7b = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, activation="swiglu", window=4096,
    n_experts=8, topk=2, block_pattern=("moe",),
    source="arXiv:2401.04088 (8 experts top-2, SWA)")

recurrentgemma_2b = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, activation="geglu",
    block_pattern=("rglru", "rglru", "lattn"),    # RG-LRU : local attn = 2:1
    rnn_width=2560, conv_width=4, local_window=2048,
    source="arXiv:2402.19427 (RG-LRU + local attn, 1:2)")

# The paper's own demo config: a small dense LM run entirely in the
# square-form number system (matmul_mode=square_virtual).
fairsquare_demo = ModelConfig(
    name="fairsquare-demo", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=32000, activation="swiglu", matmul_mode="square_virtual",
    source="this paper: square-form arithmetic end to end")

ARCHS = {c.name: c for c in [
    paligemma_3b, xlstm_350m, h2o_danube_3_4b, command_r_35b, deepseek_7b,
    starcoder2_3b, whisper_large_v3, moonshot_v1_16b_a3b, mixtral_8x7b,
    recurrentgemma_2b, fairsquare_demo,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
