"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf tier]

Per the assignment, the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (n_img_tokens x d_model) which the
backbone prepends to the text token embeddings.  576 patch tokens (24x24,
the CLIP-ViT-L/14 336px grid).  Full attention => long_500k SKIPPED.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    head_dim=96,
    attn_kind="full",
    mlp_kind="swiglu",
    n_img_tokens=576,
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    supports_long_context=False,
)
