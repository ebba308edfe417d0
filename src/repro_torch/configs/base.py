"""Model / run configuration system (port of ``repro.configs.base``).

Every architecture is a ``ModelConfig`` instance in its own
``repro_torch/configs/<id>.py`` module (verbatim copies of the
reference's), resolved by ``get_config(name)``.  This module is a port,
not a copy: ``get_config`` imports by module name, and that name must be
the port's.  ``ShapeConfig`` cells (train_4k / prefill_32k / decode_32k /
long_500k) are kept as plain data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape configs (assigned per the task: seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what step to lower and at what size."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture; exact numbers from the assignment table."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: int = 0  # 0 => d_model // n_heads
    attn_kind: str = "full"  # full | swa (sliding window) | local (block-local)
    window: int = 0  # sliding/local window size (tokens)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # --- mlp ---
    mlp_kind: str = "swiglu"  # swiglu | relu2 | gelu
    mlp_bias: bool = False

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dense"  # dense (dispatch-einsum, FSDP weights) | ep (shard_map expert parallel)

    # --- hybrid / ssm block pattern ---
    # repeating unit of block kinds, e.g. ('rec','rec','attn') for griffin,
    # ('mlstm','mlstm','mlstm','slstm') for xlstm.  Empty => all 'attn'.
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0  # RG-LRU recurrence width (0 => d_model)
    conv_width: int = 4  # temporal conv in recurrent blocks
    mlstm_chunk: int = 256  # chunk size for chunkwise-parallel mLSTM

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1_500  # whisper: 30s of audio at 50 fps after conv stride 2

    # --- vlm stub ---
    n_img_tokens: int = 0  # patch embeddings prepended to the text sequence

    # --- positions / norms / embeddings ---
    pos_kind: str = "rope"  # rope | learned | sinusoidal | none
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- precision & perf knobs (hillclimb levers) ---
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master params (train); serving casts to dtype
    remat: str = "full"  # none | full | dots — activation checkpoint policy
    scan_layers: bool = True  # lax.scan over layer units (compile-size control)
    # 'blockwise' = flash-style online-softmax scan (memory-sane, used for
    # real execution); 'direct' = plain masked-softmax einsum — used by the
    # dry-run COST PROBE so cost_analysis sees attention FLOPs outside a
    # while body (scan bodies are counted once by XLA cost analysis).
    attn_impl: str = "blockwise"
    # Pad attention heads up to a multiple of the TP degree (0 = off).
    # Head counts that don't divide the model axis (qwen2: 28H, whisper:
    # 12H on a 16-way axis) otherwise fall back to head_dim-sharded
    # attention, whose contracting partial-sums are collective-bound.
    # Padded q heads have ZEROED output-projection rows (function-
    # preserving at init; training would mask their grads — §Perf).
    pad_heads_multiple: int = 0

    @property
    def n_heads_p(self) -> int:
        m = self.pad_heads_multiple
        if not m:
            return self.n_heads
        return ((self.n_heads + m - 1) // m) * m

    @property
    def n_kv_p(self) -> int:
        if not self.pad_heads_multiple:
            return self.n_kv_heads
        hp = self.n_heads_p
        return self.n_kv_heads if hp % self.n_kv_heads == 0 else hp

    # long-context capability: archs with bounded state (window attention,
    # recurrent state) can run the long_500k decode shape sub-quadratically.
    # Pure full-attention archs skip it (recorded in DESIGN.md).
    supports_long_context: bool = False

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def resolved_pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    @property
    def unit_len(self) -> int:
        return len(self.resolved_pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.unit_len

    @property
    def n_rem_layers(self) -> int:
        """Layers that do not fill a whole repeating unit (prepended,
        un-scanned, using the first block kinds of the pattern)."""
        return self.n_layers - self.n_units * self.unit_len

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- reduced config for CPU smoke tests -----
    def reduced(self) -> "ModelConfig":
        """Same family/topology, tiny dimensions: one scanned unit (plus the
        remainder structure), small width, few experts, tiny vocab."""
        unit = self.unit_len
        n_layers = unit + (1 if self.n_rem_layers else 0) * min(self.n_rem_layers, unit - 1)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return self.replace(
            n_layers=max(n_layers, unit),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 32) if self.window else 0,
            rnn_width=64 if self.rnn_width or self.family in ("hybrid", "ssm") else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=24 if self.is_encdec else self.enc_seq,
            n_img_tokens=8 if self.n_img_tokens else 0,
            mlstm_chunk=16,
            param_dtype="float32",
            dtype="float32",
            remat="none",
        )


def get_config(name: str) -> ModelConfig:
    """Resolve an architecture id (e.g. 'mixtral-8x22b') to its config."""
    import importlib

    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


ARCH_IDS = (
    "recurrentgemma-9b",
    "xlstm-350m",
    "mixtral-8x22b",
    "phi3.5-moe-42b-a6.6b",
    "phi-3-vision-4.2b",
    "whisper-small",
    "qwen3-1.7b",
    "qwen2-7b",
    "minitron-8b",
    "granite-3-8b",
)
