"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088; hf tier]

SWA window 4096 (Mixtral lineage).  Windowed KV bounds the decode cache =>
long_500k runs with a ring-buffer cache of `window` tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    head_dim=128,
    attn_kind="swa",
    window=4096,
    mlp_kind="swiglu",
    n_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    supports_long_context=True,
)
