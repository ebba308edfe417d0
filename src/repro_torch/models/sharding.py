"""Logical-axis sharding (port of ``repro.models.sharding``): the rule
table, the greedy logical -> mesh assignment, the virtual KV-head count,
and ``Sharder``, which places parameters and activations on a
``torch.distributed.device_mesh.DeviceMesh`` as DTensor placements.

Every parameter and activation of the reference is annotated with
*logical* axis names ('embed', 'heads', 'mlp', ...).  A rule table maps a
logical name to an ordered list of *mesh*-axis candidates; ``spec_for``
greedily assigns the first candidate that (a) exists in the mesh, (b) is
not already used by another dim of the same tensor, and (c) divides the
dim size.  Indivisible or unavailable candidates fall through — e.g.
qwen2's 28 heads cannot shard over a 16-way model axis, so the
'head_dim' dim (128) picks up the model axis instead.  One rule table
stays valid for every architecture and both production meshes.

``spec_for`` takes a mesh as its axis names and sizes (a mapping, in
mesh order); a spec is a tuple of mesh axes per dimension (a tuple of
axes for a dimension sharded over several), trailing ``None``s trimmed as
the reference trims them.  ``placements`` turns a spec into one DTensor
placement per mesh dimension: ``Shard(dim)`` for a mesh axis a tensor
dimension names, ``Replicate()`` for every other.  ``Sharder`` is the
reference's: ``act`` is ``with_sharding_constraint`` (a ``redistribute``,
a no-op without a mesh or for an all-``None`` spec), ``param_sharding``
and ``tree_shardings`` give placements, ``distribute`` replaces a model's
parameters by DTensors, and ``local`` runs a kernel on each rank's block
(``local_map``, the counterpart of ``shard_map``).  Model code asks the
``Sharder`` how a tensor is placed (``shards``, ``like``, ``replicated``,
``whole``) rather than testing for DTensors itself.  Parameters carry
their logical axes as the attribute ``axes`` (``models.common.Init``);
``param_axes`` collects them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, local_map

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
    on a 16-way axis -> head_dim sharding takes over instead)."""
    if n_kv % model_axis == 0:
        return n_kv
    v = n_kv
    while v <= n_heads:
        if v % n_kv == 0 and n_heads % v == 0 and v % model_axis == 0:
            return v
        v += n_kv
    return n_kv


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> Dict[str, int]:
    """A DeviceMesh's axis names and sizes, in mesh order (``spec_for``'s
    mesh)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: Spec, mesh) -> List:
    """One placement per mesh dimension for a ``spec_for`` spec: a mesh
    axis named in tensor dimension d's entry gives ``Shard(d)``, every
    other mesh axis ``Replicate()``.  A joint entry such as
    ``("pod", "data")`` shards its dimension over both, in mesh order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(dim)
    return out


def param_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's logical axes by parameter name (a per-layer
    module's, without the reference's stacked "layers" axis)."""
    return {name: p.axes for name, p in model.named_parameters()}


def place(value, mesh, placements, device=None) -> DTensor:
    """This rank's chunk of ``value`` (a tensor or an array, whole on
    every rank) as a DTensor with ``placements``: a dimension sharded
    over mesh dimension i keeps chunk ``mesh.get_local_rank(i)``, in mesh
    order (torch.chunk's split, as DTensor's).  Only a copy of the chunk
    goes to ``device`` (default: the mesh's; a meta chunk stays on meta);
    nothing is broadcast."""
    full = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    local = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    if local.is_meta:  # a dry run's stand-in stays on meta
        device = local.device
    elif device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    # a copy of its own: a view would keep the whole value's storage alive
    local = local.to(device, memory_format=torch.contiguous_format, copy=True)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


def flat_matmul(x, w):
    """x (..., K) @ w (K, *out) -> (..., *out), one product over w's output
    dimensions flattened.  A DTensor w that shards an output dimension
    other than the first has it moved first for the product (the
    flattened columns then split evenly: DTensor cannot unflatten them
    otherwise) and back after."""
    moved = [p.dim for p in getattr(w, "placements", ()) if isinstance(p, Shard) and p.dim > 1]
    if not moved:
        return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    w = w.movedim(moved[0], 1)
    y = (x @ w.flatten(1)).unflatten(-1, w.shape[1:])
    return y.movedim(x.dim() - 1, x.dim() - 2 + moved[0])


def redistributed(x, mesh, placements) -> DTensor:
    """``x`` with ``placements``: a DTensor redistributed, a plain tensor
    taken as replicated on every rank."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, list(placements))


_SCOPE_DEPTH = [0]


@dataclasses.dataclass
class Sharder:
    """Threads a mesh and the rules through model code.  ``mesh=None``
    (one device) makes every annotation a no-op, so the same model code
    runs unsharded."""

    mesh: Any = None  # a torch.distributed.device_mesh.DeviceMesh
    rules: Rules = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    @property
    def model_axis(self) -> int:
        """The size of the mesh's "model" axis (1 without one)."""
        return mesh_axes(self.mesh).get("model", 1) if self.mesh is not None else 1

    def spec(self, shape, axes) -> Spec:
        return spec_for(shape, axes, self.rules, mesh_axes(self.mesh))

    def act(self, x, *axes: Optional[str]):
        """Constrain an activation's placements by logical axis names;
        an all-None spec is a no-op, as the reference's."""
        if self.mesh is None:
            return x
        spec = self.spec(x.shape, axes)
        if not any(s is not None for s in spec):
            return x
        return redistributed(x, self.mesh, placements(spec, self.mesh))

    def param_sharding(self, value, axes) -> List:
        assert self.mesh is not None
        return placements(self.spec(value.shape, axes), self.mesh)

    def tree_shardings(self, values_tree, axes_tree):
        """Placements for a (values, axes) pair of trees (dicts, lists and
        tuples of tensors, and of axis tuples)."""
        return _map_axes(self.param_sharding, values_tree, axes_tree)

    def place_tree(self, values_tree, axes_tree):
        """``values_tree`` (whole on every rank) with each tensor placed by
        its axes (``place``: each rank keeps its chunk)."""
        return _map_axes(lambda v, a: place(v, self.mesh, self.param_sharding(v, a)),
                         values_tree, axes_tree)

    def distribute(self, model: nn.Module) -> nn.Module:
        """Replace each parameter of ``model`` (in place) by a DTensor
        placed by its logical axes; returns the model."""
        if self.mesh is None:
            return model
        for module in model.modules():
            for name, p in list(module._parameters.items()):
                if p is None or isinstance(p.data, DTensor):
                    continue
                d = distribute_tensor(p.detach(), self.mesh, self.param_sharding(p, p.axes))
                q = nn.Parameter(d, requires_grad=p.requires_grad)
                q.axes = p.axes
                module._parameters[name] = q
        return model

    def scope(self):
        """The context a sharded step runs in: plain tensors (positions,
        masks, the optimizer's scalars) count as replicated beside
        DTensors.  Re-entrant; a no-op without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _scope()

    @staticmethod
    def shards(x, *dims: int) -> bool:
        """Whether ``x`` is a DTensor sharded on any of tensor dimensions
        ``dims``."""
        return isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim in dims for p in x.placements)

    @staticmethod
    def like(t, like, dims: Sequence[int]):
        """``t`` placed as ``like`` on tensor dimensions ``dims`` and
        replicated on every other (a plain ``t`` taken as replicated);
        ``t`` itself when ``like`` is not a DTensor."""
        if not isinstance(like, DTensor):
            return t
        return redistributed(t, like.device_mesh, kept(like.placements, dims))

    @staticmethod
    def whole(x):
        """``x`` whole as a plain tensor (a DTensor's ``full_tensor()``)."""
        return x.full_tensor() if isinstance(x, DTensor) else x

    def replicated(self, x):
        """``x`` whole on every rank as a DTensor (a plain tensor taken as
        replicated); ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        return redistributed(x, self.mesh, [Replicate()] * self.mesh.ndim)

    def local(self, fn: Callable, tensors: Sequence, keep: Sequence, *rest, **kw):
        """``fn(*tensors, *rest, **kw)`` on each rank's block (``local_map``,
        the counterpart of ``shard_map``).  Each tensor is placed as the
        first one is on the tensor dimensions in ``keep`` (one tuple of
        dimensions for every tensor, or one tuple per tensor) and
        replicated on every other (``fn`` is local over those
        dimensions); ``rest`` passes through as it is.  The result has the
        first tensor's placements.  Without a mesh, or on plain tensors, a
        direct call."""
        x = tensors[0]
        if self.mesh is None or not isinstance(x, DTensor):
            return fn(*tensors, *rest, **kw)
        keeps = keep if isinstance(keep[0], tuple) else (keep,) * len(tensors)
        pls = [kept(x.placements, dims) for dims in keeps]
        ts = [redistributed(t, self.mesh, pl) for t, pl in zip(tensors, pls)]
        body = functools.partial(fn, **kw) if kw else fn
        return local_map(body, out_placements=pls[0],
                         in_placements=tuple(pls) + (None,) * len(rest),
                         device_mesh=self.mesh)(*ts, *rest)


def kept(placements, dims: Sequence[int]) -> List:
    """``placements`` with only the shards of tensor dimensions ``dims``
    kept, every other mesh dimension ``Replicate()``."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in placements]


def _map_axes(fn, values, axes):
    """``fn(value, axes)`` at each leaf of an axes tree (a leaf: a tuple
    of axis names and Nones), the values tree alongside."""
    if isinstance(axes, tuple) and all(isinstance(e, (str, type(None))) for e in axes):
        return fn(values, axes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, values[k], a) for k, a in axes.items()}
    return type(axes)(_map_axes(fn, v, a) for v, a in zip(values, axes))


@contextlib.contextmanager
def _scope():
    _SCOPE_DEPTH[0] += 1
    try:
        if _SCOPE_DEPTH[0] > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _SCOPE_DEPTH[0] -= 1


NO_SHD = Sharder()
