"""qwen3-1.7b [dense] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
[hf:Qwen/Qwen3-8B family; hf tier]

Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    attn_kind="full",
    qk_norm=True,
    qkv_bias=False,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    supports_long_context=False,
)
