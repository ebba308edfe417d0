"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000
[arXiv:2402.19427 (Griffin) / RecurrentGemma; unverified tier]

Pattern: repeating unit (rec, rec, attn); 38 = 12*3 + 2 — the two remainder
layers are recurrent blocks prepended before the scanned units (Griffin
starts with recurrent blocks).  Local attention window 2048 per the Griffin
paper.  Bounded state (RG-LRU state + windowed KV) => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    attn_kind="swa",
    window=2048,
    mlp_kind="swiglu",
    block_pattern=("rec", "rec", "attn"),
    rnn_width=4096,
    conv_width=4,
    pos_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    attn_logit_softcap=0.0,
    supports_long_context=True,
)
