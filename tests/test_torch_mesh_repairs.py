"""Multi-card repairs of the port, each held in subprocesses (a
process group never starts in the pytest process):

* ``moe.routed_tokens``: the MoE's (B, S, D) -> (T, D) reshape and the
  no-op constraint after it, on a fake 8-rank (pod=2, data=2, model=2)
  group with tiny CPU tensors.  The tokens' gradient comes back sharded
  over every mesh axis (a product with a tensor placed so); with the
  constraint the input's gradient has its local shape, and without it
  (the reshape alone) DTensor's reshape backward takes a wrong local
  shape and raises, here on torch 2.13 as on the production 2 x 16 x 16
  mesh where the fault appeared (torch 2.11).
* ``xlstm_blocks._merged_heads``: an xLSTM block's (B, S, H, dh) ->
  (B, S, H * dh) merge and the constraint after it, on a fake 16-rank
  (data=2, model=8) group: 4 heads whose dh is sharded 8 ways, and a
  gradient that comes back sharded 8 ways over the merged dimension.
  With the constraint it is brought to the merge's placements first;
  without it DTensor's merge backward cannot unflatten it and raises
  (the fault of ``xlstm-350m``'s full-size mesh cells, 16-wide model
  axis).
* the xLSTM recurrences on a (data=2, model=2) mesh of four ``gloo``
  processes: ``slstm_sequence`` and the chunkwise mLSTM
  (``_mlstm_sequence``) run on each rank's batch rows and heads as plain
  tensors (``xlstm_blocks._per_rank``) against the same recurrences
  stepped op by op on the DTensors (``_slstm_steps``,
  ``mlstm_chunkwise``), and both against the unsharded call, forward (h,
  the final state) and backward (the gradients of the inputs and of every
  weight).  The sharded paths run the same local operations, but DTensor
  picks other placements for some of them (the zero first state counts
  as replicated, so step 0's products run at other shapes), so the bits
  may differ: within 1e-6 of each tensor's largest value, float32.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
LOCAL_TOL = 1e-6  # of each tensor's largest value, float32

ROUTED = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import moe
    from repro_torch.models.sharding import Sharder
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    shd = Sharder(mesh)
    B, S, D = 4, 8, 16
    out = {}
    for name, tokens in (("constrained", moe.routed_tokens),
                         ("reshape_alone", lambda x, shd: shd.act(x, "batch", None, None)
                          .reshape(B * S, D))):
        local = torch.randn(B // 4, S, D).requires_grad_()
        x = DTensor.from_local(local, mesh, [Shard(0), Shard(0), Replicate()],
                               shape=(B, S, D), stride=(S * D, D, 1))
        x2d = tokens(x, shd)
        w = DTensor.from_local(torch.randn(B * S // 8, D), mesh, [Shard(0)] * 3,
                               shape=(B * S, D), stride=(D, 1))
        rec = {"tokens": [str(p) for p in x2d.placements]}
        try:
            (x2d * w).sum().backward()
            rec["grad_local_shape"] = list(local.grad.shape)
        except RuntimeError as e:
            rec["error"] = str(e)[:300]
        rec["local_shape"] = list(local.shape)
        out[name] = rec
    print(json.dumps(out))
    """)

MERGED = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import xlstm_blocks as xl
    from repro_torch.models.common import group_norm_heads
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("data", "model"))
    B, S, H, d = 4, 3, 4, 16
    out = {}
    for name, merge in (("constrained", xl._merged_heads),
                        ("merge_alone", lambda h, sc: group_norm_heads(h, sc).reshape(B, S, -1))):
        local = torch.randn(B // 2, S, H, d // 8).requires_grad_()
        h = DTensor.from_local(local, mesh, [Shard(0), Shard(3)], shape=(B, S, H, d),
                               stride=(S * H * d, H * d, d, 1))
        scale = DTensor.from_local(torch.ones(H, d // 8), mesh, [Replicate(), Shard(1)],
                                   shape=(H, d), stride=(d, 1))
        w = DTensor.from_local(torch.randn(B // 2, S, H * d // 8), mesh, [Shard(0), Shard(2)],
                               shape=(B, S, H * d), stride=(S * H * d, H * d, 1))
        rec = {"local_shape": list(local.shape)}
        try:
            (merge(h, scale) * w).sum().backward()
            rec["grad_local_shape"] = list(local.grad.shape)
        except RuntimeError as e:
            rec["error"] = str(e)[:300]
        out[name] = rec
    print(json.dumps(out))
    """)

RECURRENCES = textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm_blocks as xl
    from repro_torch.models.common import Init
    from repro_torch.models.sharding import Sharder, flat_matmul
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config("xlstm-350m").reduced()
    B, S, D, H = 4, 2 * cfg.mlstm_chunk, cfg.d_model, cfg.n_heads
    whole = Sharder.whole
    g = torch.Generator().manual_seed(1)

    def leaf(t, shd, placements):
        t = t.clone() if shd.mesh is None else distribute_tensor(t, mesh, placements)
        return t.requires_grad_()

    def slstm(how):
        p = xl.SLSTMBlock(Init(torch.Generator().manual_seed(0), torch.float32,
                               torch.device("cpu")), cfg)
        p.requires_grad_(True)
        shd = Sharder(None if how == "unsharded" else mesh)
        shd.distribute(p)
        x = leaf(X, shd, [Shard(0), Replicate()])
        state = [torch.zeros(B, H, D // H)] * 4  # a prefill's
        with shd.scope():
            if how == "dtensor":  # the recurrence op by op on the DTensors
                hs, *st = xl._slstm_steps(flat_matmul(x, p.w) + p.b, *state, p.r)
            else:
                hs, st = xl.slstm_sequence(p, x, tuple(state), shd)
            (hs * DHS).sum().backward()
        return {"hs": whole(hs.detach()), "state": [whole(t.detach()) for t in st],
                "dx": whole(x.grad), **{"d" + k: whole(v.grad) for k, v in p.named_parameters()
                                        if v.grad is not None}}

    def mlstm(how):
        shd = Sharder(None if how == "unsharded" else mesh)
        ins = [leaf(t, shd, [Shard(0), Shard(2)]) for t in QKVIF]
        with shd.scope():
            if how == "dtensor":  # the chunk loop op by op on the DTensors
                h, st = xl.mlstm_chunkwise(*ins, cfg.mlstm_chunk)
                out = (h, *st)
            else:
                out = xl._mlstm_sequence(*ins, cfg.mlstm_chunk, shd)
            (out[0] * DH).sum().backward()
        return {"h": whole(out[0].detach()), "state": [whole(t.detach()) for t in out[1:]],
                **{"d" + n: whole(t.grad) for n, t in zip(("q", "k", "v", "i", "f"), ins)}}

    X = torch.randn(B, S, D, generator=g)
    DHS = torch.randn(B, S, H, D // H, generator=g)
    dk = 2 * D // H
    QKVIF = [torch.randn(B, S, H, dk, generator=g) for _ in range(3)] + [
        torch.randn(B, S, H, generator=g) for _ in range(2)]
    DH = torch.randn(B, S, H, dk, generator=g)
    out = {name: {how: fn(how) for how in ("local", "dtensor", "unsharded")}
           for name, fn in (("slstm", slstm), ("mlstm", mlstm))}
    if rank == 0:
        torch.save(out, f"{d}/recurrences.pt")
    dist.destroy_process_group()
    """)
KEYS = {"slstm": {"hs", "state", "dx", "dw", "dr", "db"},
        "mlstm": {"h", "state", "dq", "dk", "dv", "di", "df"}}


def test_merged_heads_take_a_gradient_sharded_over_more_ranks_than_heads():
    rec = _json_of(MERGED)
    fixed, alone = rec["constrained"], rec["merge_alone"]
    assert fixed.get("grad_local_shape") == fixed["local_shape"] == [2, 3, 4, 2], fixed
    # the fault the constraint repairs
    assert "error" in alone and "unevenly sharded" in alone["error"], alone


@pytest.fixture(scope="module")
def recurrences(tmp_path_factory):
    d = tmp_path_factory.mktemp("recurrences")
    procs = [subprocess.Popen([sys.executable, "-c", RECURRENCES, str(r), "4", str(d)],
                              env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-2000:] for log in logs)
    return torch.load(d / "recurrences.pt", weights_only=False)


def _json_of(code):
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_routed_tokens_constraint_keeps_the_gradients_local_shape():
    rec = _json_of(ROUTED)
    fixed, alone = rec["constrained"], rec["reshape_alone"]
    assert fixed["tokens"] == ["S(0)", "S(0)", "R"]
    assert "error" not in fixed, fixed
    assert fixed["grad_local_shape"] == fixed["local_shape"] == [1, 8, 16]
    # the fault the constraint repairs
    assert "error" in alone and "is invalid for input of size" in alone["error"], alone


@pytest.mark.parametrize("block", ["slstm", "mlstm"])
def test_local_recurrence_matches_the_dtensor_steps(recurrences, block):
    local, dtensor, unsharded = (recurrences[block][h] for h in ("local", "dtensor", "unsharded"))
    assert set(local) == set(dtensor) == set(unsharded) == KEYS[block]
    for key in local:
        for want in (dtensor, unsharded):
            a, w = local[key], want[key]
            for i, (t, u) in enumerate(zip(a, w) if isinstance(a, list) else [(a, w)]):
                lim = LOCAL_TOL * float(u.abs().max())
                torch.testing.assert_close(t, u, atol=lim, rtol=LOCAL_TOL, msg=f"{key}[{i}]")
