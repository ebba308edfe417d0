"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf tier]

Full attention => long_500k SKIPPED (pure full-attention arch; see
DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    head_dim=128,
    attn_kind="full",
    mlp_kind="swiglu",
    n_experts=16,
    top_k=2,
    rope_theta=10_000.0,
    norm_kind="layernorm",  # Phi-3.5-MoE uses LayerNorm
    supports_long_context=False,
)
