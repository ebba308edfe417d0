"""granite-3-8b [dense] — GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0 family; hf tier]

Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49_155,
    head_dim=128,
    attn_kind="full",
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    supports_long_context=False,
)
