"""minitron-8b [dense] — pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000
[arXiv:2407.14679; hf tier]

Nemotron lineage: squared-ReLU MLP (non-gated), no bias.  Full attention
=> long_500k SKIPPED.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256_000,
    head_dim=128,
    attn_kind="full",
    mlp_kind="relu2",
    rope_theta=10_000.0,
    norm_kind="layernorm",  # nemotron uses LayerNorm-1p; plain LN here
    supports_long_context=False,
)
