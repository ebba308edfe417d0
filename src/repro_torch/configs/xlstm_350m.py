"""xlstm-350m [ssm] — sLSTM + mLSTM blocks.

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified tier]

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM uses a
pre-up-projection block with expansion 2, sLSTM a post-gated-FFN with
expansion 4/3) — there is no separate transformer FFN.  Pattern: the paper's
xLSTM[a:b] notation mixes mLSTM and sLSTM blocks; we use a repeating unit of
(m, m, m, s) => 6 units over 24 layers (an xLSTM[3:1]-style ratio).  O(1)
recurrent state => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=256,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    conv_width=4,
    mlstm_chunk=256,
    pos_kind="none",  # recurrence encodes position
    norm_kind="layernorm",
    tie_embeddings=True,
    supports_long_context=True,
)
