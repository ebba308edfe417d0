"""The ranks of ``tests/test_torch_distributed.py``: one process a rank of a
``gloo`` group on the CPU, joined through a FileStore in the test's
directory (no TCP port to collide with another test).  Each rank reads
the inputs the test wrote (``inputs.pt``), runs every multi-rank check of
the port on its share, and writes what it got to ``rank<r>.pt``; the test
compares those with the unsharded port and with the reference.

    python tests/torch_dist_workers.py RANK WORLD DIR

It imports torch and ``repro_torch`` only, never ``jax`` or ``repro``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.sharding import Sharder, place
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads_podwise, init_error_state
from repro_torch.storage.checkpoint import CheckpointConfig, CheckpointStore
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.taf import exec as taf_exec
from repro_torch.train import make_prefill_step, make_serve_step, make_train_step

DECODE_STEPS = 3


def taf(inp):
    """The degree plans on a ("workers",) mesh of every rank."""
    mesh = taf_exec.make_worker_mesh()
    sots = carry.sots_from_arrays(inp["sots"])
    return {"W": mesh.size(),
            "at": taf_exec.sharded_degree_at(sots, inp["tm"], mesh=mesh, device="cpu"),
            "series": taf_exec.sharded_degree_series(sots, inp["ts"], mesh=mesh,
                                                     device="cpu")}


def train(case, mesh):
    """Float32 train steps of a carried model on a (data, model) mesh:
    each step's loss and every parameter's whole gradient."""
    cfg = get_config(case["arch"]).reduced().replace(**case["overrides"])
    shd = Sharder(mesh)
    model = lm.from_state_dict(cfg, case["state"], device="cpu")
    model.train()
    model.requires_grad_(True)
    shd.distribute(model)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(), shd)
    losses, grads = [], []
    for b in case["batches"]:
        placed = specs.batch_shardings(b, shd)
        batch = {k: place(v, mesh, placed[k]) for k, v in b.items()}
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
        grads.append({k: p.grad.full_tensor() for k, p in model.named_parameters()})
    sharded = sorted(k for k, p in model.named_parameters()
                     if any(pl.is_shard() for pl in p.placements))
    return {"losses": losses, "grads": grads, "sharded": sharded,
            "params": {k: p.full_tensor() for k, p in model.named_parameters()}}


def serve(case, mesh):
    """A prefill of the first batch's tokens and DECODE_STEPS greedy
    decode steps on the mesh (the caches as the prefill leaves them):
    every step's logits, whole."""
    cfg = get_config(case["arch"]).reduced().replace(**case["overrides"])
    shd = Sharder(mesh)
    model = shd.distribute(lm.from_state_dict(cfg, case["state"], device="cpu"))
    tokens = case["batches"][0]["tokens"]
    B, S = tokens.shape
    batch = {"tokens": place(tokens, mesh, specs.batch_shardings({"tokens": tokens},
                                                                 shd)["tokens"])}
    with torch.no_grad():
        nxt, caches = make_prefill_step(cache_len=S + DECODE_STEPS, shd=shd)(model, batch)
        step, logits = make_serve_step(shd), []
        for t in range(DECODE_STEPS):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            nxt, out, caches = step(model, caches, nxt.full_tensor()[:, None], pos)
            logits.append(out.full_tensor())
    return logits


def decode_layouts(inp, mesh):
    """Decode attention (``models.attention._decode_attend``) over a cache
    placed on the mesh in each of ``inp["layouts"]`` (a placement a mesh
    dimension), on the CPU: its output whole, and whether every call that
    reached ``decode_attention`` got a rank's block as a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.models import attention

    k, v, q, k_pos, pos = inp["decode"]
    kernel, seen = dec_ops.decode_attention, []

    def wrapper(*args, **kw):
        seen.append(not any(isinstance(t, DTensor) for t in args[:5]))
        return kernel(*args, **kw)

    dec_ops.decode_attention = wrapper
    out = {}
    try:
        for name, layout in inp["layouts"].items():
            pl = [Shard(d) if d is not None else Replicate() for d in layout]
            kd, vd = (distribute_tensor(t, mesh, pl) for t in (k, v))
            kp = distribute_tensor(k_pos, mesh, [p if not (isinstance(p, Shard) and p.dim > 1)
                                                 else Replicate() for p in pl])
            seen.clear()
            for window in (0, 5):
                got = attention._decode_attend(q, kd, vd, kp, pos, window, 0.0, Sharder(mesh))
                got = got.full_tensor() if isinstance(got, DTensor) else got
                out[(name, window)] = (got, len(seen), all(seen))
    finally:
        dec_ops.decode_attention = kernel
    return out


def checkpoint(inp, mesh):
    """Two unsharded saves, the second restored onto ``mesh`` and onto its
    1-D "data" sub-mesh of 2 ranks."""
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                            CheckpointConfig(snapshot_every=2))
    for step, tree in enumerate(inp["ckpt_trees"]):
        store.save(step, tree)
    out = {}
    for name, m in (("2x2", mesh), ("1d", mesh["data"])):
        shardings = Sharder(m).tree_shardings(inp["ckpt_trees"][-1], inp["ckpt_axes"])
        got, step = store.restore_sharded(m, shardings)
        out[name] = {"step": step,
                     "full": {k: v.full_tensor() for k, v in got["params"].items()},
                     "local_shapes": {k: tuple(v.to_local().shape)
                                      for k, v in got["params"].items()},
                     "count": got["count"].full_tensor()}
    return out


def compression(inp):
    """Two rounds of the EF-int8 pod all-reduce on a (pod=2, data=2) mesh:
    the same gradients on both pods, and each pod its own."""
    mesh = make_host_mesh((2, 2), ("pod", "data"))
    pod = mesh.get_local_rank("pod")
    out = {}
    for name, grads in (("same", inp["g_same"]), ("diff", inp["g_diff"][pod])):
        err = init_error_state(grads)
        rounds = []
        for _ in range(2):
            ghat, err = compress_grads_podwise(grads, err, mesh)
            rounds.append((ghat, err))
        out[name] = rounds
    out["no_pod"] = compress_grads_podwise(inp["g_same"], None,
                                           make_host_mesh((4,), ("data",)))[0]
    return out


def main(rank: int, world: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{DIR / 'store'}", rank=rank,
                            world_size=world)
    try:
        inp = torch.load(DIR / "inputs.pt", weights_only=False)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        out = {"taf": taf(inp),
               "train": {name: train(case, mesh) for name, case in inp["train"].items()},
               "serve": {name: serve(case, mesh) for name, case in inp["train"].items()},
               "decode_layouts": decode_layouts(inp, mesh),
               "checkpoint": checkpoint(inp, mesh),
               "compression": compression(inp)}
        torch.save(out, DIR / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    DIR = Path(sys.argv[3])
    main(int(sys.argv[1]), int(sys.argv[2]))
