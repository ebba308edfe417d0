"""Stand-ins for every model input and state (port of
``repro.launch.specs``): tensors on the ``meta`` device, which have a
shape and a type and hold nothing, where the reference uses
``jax.ShapeDtypeStruct``.  They back the dry run
(``repro_torch.launch.dryrun``).

On a mesh, ``batch_shardings`` and ``opt_state_shardings`` give the
reference's placements (as DTensor placements, ``models.sharding``), and
``cache_axes`` the logical axes of every cache entry, which
``Sharder.tree_shardings`` turns into placements.  The KV cache holds
the virtual KV heads of the mesh's model axis (``model_axis``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import Init
from repro_torch.models.sharding import Sharder
from repro_torch.optim import adamw

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Training / prefill batch: tokens + labels (+ stub modality inputs)."""
    B, S = shape.global_batch, shape.seq_len
    n_img = cfg.n_img_tokens or 0
    n_txt = S - n_img
    specs = {"tokens": torch.empty((B, n_txt), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((B, n_txt), dtype=torch.int32, device=META)
    if n_img:
        specs["img_embeds"] = torch.empty((B, n_img, cfg.d_model), dtype=torch.float32,
                                          device=META)
    if cfg.is_encdec:
        specs["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=torch.float32,
                                      device=META)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model_axis: int = 1,
                 cache_len: int = 0):
    """(caches, tokens, pos) for one decode step with a cache of
    ``cache_len`` (default ``shape.seq_len``) entries."""
    B = shape.global_batch
    cache = lm.init_cache(cfg, B, cache_len or shape.seq_len, META, model_axis)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    pos = torch.empty((B,), dtype=torch.int32, device=META)
    return cache, tokens, pos


def cache_axes(cfg: ModelConfig) -> list:
    """The logical axes of every entry of ``lm.init_cache``'s caches, one
    dict a layer, as the reference's ``init_cache`` tags them."""
    out = []
    for kind in lm.layer_kinds(cfg):
        if kind == "attn":
            kv = ("batch", "kv_seq", "kv_heads", "head_dim")
            c = {"k": kv, "v": kv, "k_pos": ("batch", "kv_seq")}
            if cfg.is_encdec:
                c.update(ck=kv, cv=kv)
            out.append({"attn": c})
        elif kind == "rec":
            out.append({"rec": {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}})
        elif kind == "mlstm":
            out.append({"mix": {"C": ("batch", "heads", "head_dim", None),
                                "n": ("batch", "heads", "head_dim"), "m": ("batch", "heads"),
                                "conv": ("batch", None, "act_mlp")}})
        else:
            out.append({"mix": {k: ("batch", "heads", "head_dim") for k in "cnhm"}})
    return out


def batch_shardings(specs: Dict, shd: Sharder) -> Dict[str, list]:
    """Each batch entry's placements: "batch" on its leading dimension."""
    return {k: shd.param_sharding(v, ("batch",) + (None,) * (len(v.shape) - 1))
            for k, v in specs.items()}


def opt_state_shardings(param_shardings: Dict[str, list], mesh) -> Dict:
    """AdamW's state: the moments placed as their parameters, the step
    count replicated."""
    return {"m": param_shardings, "v": param_shardings,
            "count": [Replicate()] * mesh.ndim}


def abstract_params(cfg: ModelConfig, max_seq: int) -> lm.LM:
    """The model with every parameter on ``meta`` (``lm.init`` draws
    from a generator, which ``meta`` has none of)."""
    return lm.LM(cfg, Init(None, getattr(torch, cfg.param_dtype), META), max_seq).eval()


def abstract_opt_state(model: nn.Module) -> Dict:
    return adamw.init(dict(model.named_parameters()))


def n_params(model: nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())


def n_active_params(cfg: ModelConfig, model: nn.Module) -> int:
    """Active params per token (MoE: top_k of n_experts expert params)."""
    total = n_params(model)
    if not cfg.is_moe:
        return total
    # expert weights are the (E, D, F) tensors under 'ffn'
    expert_total = sum(math.prod(p.shape) for name, p in model.named_parameters()
                       if name.split(".")[-1] in ("w_gate", "w_up", "w_down")
                       and p.dim() >= 3)
    dense = total - expert_total
    return dense + expert_total * cfg.top_k // cfg.n_experts
