"""Error-feedback gradient compression for the cross-pod all-reduce
(port of ``repro.optim.compression``).

On a multi-pod mesh the inter-pod links are the thin pipe: parameters
are replicated pod-wise, so each step moves one full gradient copy across
pods.  That traffic is compressed to int8 with one scale per CHUNK
values and error feedback (the residual carried beside the optimizer
state), the 1-bit-Adam / EF-SGD recipe:

    q = quantize(g + e);  e' = (g + e) - dequant(q);  allreduce(q)

The all-reduce is ``torch.distributed.all_reduce`` over the mesh's
"pod" sub-group of each rank's dequantized contribution, divided by the
pod count: the reference's ``psum(q * scale) / npods``, the same
arithmetic (its traffic accounting takes the int8 + scale wire size).
Where the reference runs under ``shard_map`` with every leaf whole on
each device, the port works on each rank's own tensor: for a DTensor
gradient it chunks the rank's local shard, which equals the reference
whenever the leaf is whole on each rank (replicated over every mesh
axis but "pod"); a sharded leaf is chunked shard by shard, so its
chunk boundaries, and with them its scales, differ from the reference's
(ROADMAP Queue 3).  As in the reference, nothing in the train step calls
it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

CHUNK = 2048


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization. x: float32 (n,) padded to
    CHUNK."""
    xc = x.reshape(-1, CHUNK)
    scale = (xc.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(xc / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)


def ef_compress_leaf(g: torch.Tensor, err: torch.Tensor, group):
    """Error-feedback int8 all-reduce of one gradient leaf over the
    process group ``group`` (the pod axis).  Returns (g_hat, the mean of
    the pods' dequantized contributions, float32 in g's shape; new_err)."""
    n = g.numel()
    flat = g.to(torch.float32).reshape(-1) + err.reshape(-1)
    q, scale = _quantize(F.pad(flat, (0, (-n) % CHUNK)))
    contrib = _dequantize(q, scale)[:n]
    new_err = (flat - contrib).reshape(g.shape)
    summed = contrib.clone()
    dist.all_reduce(summed, group=group)
    npods = float(dist.get_world_size(group))
    return (summed / npods).reshape(g.shape), new_err


def _leaf(g, err, mesh, group):
    if not isinstance(g, DTensor):
        return ef_compress_leaf(g, err, group)
    ghat, new_err = ef_compress_leaf(g.to_local(), err.to_local(), group)
    pod = mesh.mesh_dim_names.index("pod")
    pl = list(g.placements)
    pl[pod] = Replicate()  # summed over the pods
    return (DTensor.from_local(ghat, mesh, pl, run_check=False),
            DTensor.from_local(new_err, mesh, err.placements, run_check=False))


def _map2(fn, a, b):
    if isinstance(a, dict):
        pairs = {k: _map2(fn, a[k], b[k]) for k in a}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    if isinstance(a, (list, tuple)):
        pairs = [_map2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs)
    return fn(a, b)


def compress_grads_podwise(grads, err_tree, mesh):
    """The EF-int8 all-reduce over the mesh's "pod" axis for every
    gradient leaf of ``grads`` (dicts, lists and tuples of tensors), with
    ``err_tree`` the residuals in the same layout.  Returns (g_hat tree,
    new residual tree); the identity when the mesh has no "pod" axis."""
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        return grads, err_tree
    group = mesh.get_group("pod")
    return _map2(lambda g, e: _leaf(g, e, mesh, group), grads, err_tree)


def init_error_state(params):
    """Zero residuals in float32 beside every parameter (dicts, lists and
    tuples of tensors)."""
    if isinstance(params, dict):
        return {k: init_error_state(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(init_error_state(v) for v in params)
    return torch.zeros_like(params, dtype=torch.float32)
