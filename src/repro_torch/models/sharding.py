"""Logical-axis sharding rules (port of ``repro.models.sharding``, its pure
part): the rule table, the greedy logical -> mesh assignment and the
virtual KV-head count.

Every parameter and activation of the reference is annotated with
*logical* axis names ('embed', 'heads', 'mlp', ...).  A rule table maps a
logical name to an ordered list of *mesh*-axis candidates; ``spec_for``
greedily assigns the first candidate that (a) exists in the mesh, (b) is
not already used by another dim of the same tensor, and (c) divides the
dim size.  Indivisible or unavailable candidates fall through — e.g.
qwen2's 28 heads cannot shard over a 16-way model axis, so the
'head_dim' dim (128) picks up the model axis instead.  One rule table
stays valid for every architecture and both production meshes.

Here a mesh is its axis names and sizes (a mapping, in mesh order), and
a spec is a tuple of mesh axes per dimension (a tuple of axes for a
dimension sharded over several), trailing ``None``s trimmed as the
reference trims them.  The port runs on one card, so nothing here places
a tensor yet: ``Sharder`` (threading the rules through the model as
DTensor placements) waits for the multi-card slice, and with it the
batch, optimizer-state and cache shardings of ``launch/specs.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

# Candidate lists: each entry is a tuple of mesh axes used jointly for a dim.
Rules = Dict[str, Tuple[Tuple[str, ...], ...]]
Spec = Tuple[Any, ...]

# Default (baseline) rule table of the reference's dry run.
DEFAULT_RULES: Rules = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": (),
    "kv_seq": (),  # overridden to (('data',),) for long-context decode (SP)
    # Megatron-style sequence-parallel residual stream: between blocks the
    # (B,S,D) residual is sharded S->model ('res_seq'); intra-block
    # tensors keep full S ('seq').
    "res_seq": (("model",),),
    "act_embed": (),
    "act_heads": (("model",),),
    "act_mlp": (("model",),),
    "act_vocab": (("model",),),
    "act_expert": (),
    "ffn_batch": (),
    "ffn_embed": (),
    # parameters
    "embed": (("data",),),  # FSDP
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("model",),),  # fallback when heads don't divide
    "mlp": (("model",),),
    "expert": (),  # baseline: dense dispatch, experts FSDP'd via 'embed'
    "rnn": (("model",),),
    "rnn_in": (("data",),),  # FSDP dim of recurrent weights
    "layers": (),
    "conv": (),
    "pos": (),
}

LONG_CONTEXT_OVERRIDES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    # batch=1 cannot shard; put the KV sequence on the data axis instead
    # (sequence parallelism for the 500k cache).
    "kv_seq": (("data",), ("model",)),
}


def make_rules(**overrides) -> Rules:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules


class ParamLeaf(NamedTuple):
    """A value (a tensor, or a meta tensor standing in for one) bundled
    with its logical axes."""

    value: Any
    axes: Tuple[Optional[str], ...]


def is_param_leaf(x) -> bool:
    return isinstance(x, ParamLeaf)


def _map(fn, tree):
    if is_param_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def split_tree(tree):
    """Split a tree (dicts and lists) of ParamLeaf into (values, axes) trees."""
    return _map(lambda p: p.value, tree), _map(lambda p: p.axes, tree)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], rules: Rules,
             mesh: Mapping[str, int]) -> Spec:
    """Greedy logical->mesh assignment with divisibility fallback; ``mesh``
    maps each mesh axis name to its size."""
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                if not all(a in mesh for a in cand):
                    continue
                if any(a in used for a in cand):
                    continue
                size = math.prod(mesh[a] for a in cand)
                if size > 1 and dim % size == 0:
                    assigned = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def n_kv_virtual(n_heads: int, n_kv: int, model_axis: int) -> int:
    """Smallest KV-head replication target that (a) is a multiple of n_kv,
    (b) divides n_heads, and (c) is divisible by the model-axis size, so the
    KV cache shards cleanly and every device keeps aligned q/kv groups.
    Falls back to n_kv (no replication) when impossible (e.g. qwen2 28H/4kv
    on a 16-way axis -> head_dim sharding takes over instead).  One card
    means model_axis=1."""
    if n_kv % model_axis == 0:
        return n_kv
    v = n_kv
    while v <= n_heads:
        if v % n_kv == 0 and n_heads % v == 0 and v % model_axis == 0:
            return v
        v += n_kv
    return n_kv
