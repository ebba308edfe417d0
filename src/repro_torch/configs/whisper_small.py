"""whisper-small [audio] — encoder-decoder, conv frontend stubbed.

12L (12 encoder + 12 decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865
[arXiv:2212.04356; unverified tier]

The conv1d mel frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (enc_seq=1500 x d_model).  Decoder uses learned positions;
the published model caps decoder context at 448 tokens — the decode_32k /
prefill_32k shapes extend the learned-position table (mechanical config
change, recorded in DESIGN.md).  Full attention, enc-dec => long_500k
SKIPPED.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers; n_enc_layers below
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    attn_kind="full",
    qkv_bias=True,  # whisper uses biases (q,v and out; k has none — we use uniform bias)
    mlp_kind="gelu",
    mlp_bias=True,
    is_encdec=True,
    n_enc_layers=12,
    enc_seq=1500,
    pos_kind="learned",
    norm_kind="layernorm",
    tie_embeddings=True,
    supports_long_context=False,
)
