"""The collectives of a sharded step (``repro_torch.roofline.collectives``)
and the dry run on meshes (``repro_torch.launch.dryrun.lower_cell``),
each in a subprocess of its own, since a fake process group has one size
a process:

* the recorder's summary of an all-reduce (``psum``) and an all-gather on
  a fake 4-rank group against the reference's ``summarize_collectives``
  of the same collectives compiled under ``shard_map`` on 4 placeholder
  XLA devices: counts, operand bytes and wire bytes.  In float32 they are
  equal; XLA's CPU backend runs a bfloat16 collective in float32 (a
  convert before it in the HLO), so there the reference counts twice the
  bytes the recorder counts;
* ``lower_cell`` on reduced configs on fake (2, 2) and (2, 2, 2) meshes:
  a record with the reference's keys, a collective term, and per-device
  counted FLOPs against the one-card count divided by the chip count:
  equal for train and prefill, within BOUND above it for decode.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.roofline import roofline

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
# (dtype, global shape) of the all-reduce's operand and of each gathered tensor
PSUM = {"float32": (8, 128), "bfloat16": (8, 64)}
GATHER = {"float32": (16, 24), "bfloat16": (64, 32)}

PORT = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.roofline import CollectiveRecorder
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("w",))
    dtype, psum, gather = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
    dt = getattr(torch, dtype)
    rec = CollectiveRecorder()
    with rec:
        x = DTensor.from_local(torch.ones(psum, dtype=dt), mesh, [Partial()])
        x.redistribute(mesh, [Replicate()])
        rows, cols = gather
        y = DTensor.from_local(torch.ones((rows // 4, cols), dtype=dt), mesh, [Shard(0)])
        y.full_tensor()
    print(json.dumps(rec.summary()))
    """)

REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.roofline.hlo_analysis import summarize_collectives
    dtype, psum, gather = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
    mesh = jax.make_mesh((4,), ("w",))
    body = lambda a, b: (jax.lax.psum(a, "w"), jax.lax.all_gather(b, "w", tiled=True))
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("w")),
                              out_specs=(P(), P()), check_vma=False))
    dt = jnp.dtype(dtype)
    hlo = f.lower(jax.ShapeDtypeStruct(tuple(psum), dt),
                  jax.ShapeDtypeStruct(tuple(gather), dt)).compile().as_text()
    upcast = all("f32[" in l and "convert" in l for l in hlo.splitlines()
                 if " all-reduce(" in l or " all-gather(" in l)
    print(json.dumps(dict(summarize_collectives(hlo), upcast=upcast)))
    """)


def _run(code, *args, timeout=300):
    out = subprocess.run([sys.executable, "-c", code, *args], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recorder_matches_the_references_summary(dtype):
    args = (dtype, json.dumps(PSUM[dtype]), json.dumps(GATHER[dtype]))
    got, want = _run(PORT, *args), _run(REF, *args)
    scale = 2 if dtype == "bfloat16" else 1  # XLA's CPU collectives in f32
    assert want["upcast"] == (dtype == "bfloat16")
    assert got["n_ops"] == want["n_ops"] == 2
    assert set(got["by_kind"]) == set(want["by_kind"]) == {"all-reduce", "all-gather"}
    for kind, w in want["by_kind"].items():
        g = got["by_kind"][kind]
        assert g["count"] == w["count"] == 1
        assert g["operand_bytes"] * scale == w["operand_bytes"]
        assert g["wire_bytes"] * scale == w["wire_bytes"]
    assert got["operand_bytes"] * scale == want["operand_bytes"]
    assert got["wire_bytes"] * scale == want["wire_bytes"]
    assert got["cross_pod_wire_bytes"] == want["cross_pod_wire_bytes"] == 0
    itemsize = 4 if dtype == "float32" else 2
    n = PSUM[dtype][0] * PSUM[dtype][1] * itemsize
    assert got["by_kind"]["all-reduce"] == {"count": 1, "operand_bytes": n,
                                            "wire_bytes": 2 * n * 3 / 4}


LOWER = textwrap.dedent("""
    import json, sys
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    arch, mesh, S = sys.argv[1], tuple(json.loads(sys.argv[2])), int(sys.argv[3])
    out = {}
    for kind in sys.argv[4:]:
        rec = dryrun.lower_cell(arch, ShapeConfig("reduced " + kind, S, 4, kind),
                                len(mesh) == 3, reduced=True, mesh_shape=mesh)
        out[kind] = rec
    print(json.dumps(out, default=float))
    """)
RECORD_KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "n_params", "n_active_params",
               "tokens_per_step", "memory", "cost", "collectives", "analytic", "roofline"}
COLLECTIVE_KEYS = {"by_kind", "n_ops", "operand_bytes", "wire_bytes", "cross_pod_wire_bytes"}
# one-card count / chips <= per-device count <= BOUND[kind] x it.  Train
# and prefill split every product over the chips (1.0 on both meshes);
# DTensor picks each product's placements by the cheapest redistribution
# of its inputs and computes some of the one-token decode step's whole on
# every model rank (1.036 for recurrentgemma at 2 x 2, 1.0 for qwen3 at
# 2 x 2 x 2).
BOUND = {"train": 1.0, "prefill": 1.0, "decode": 1.25}


KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("arch,mesh", [("recurrentgemma-9b", (2, 2)), ("qwen3-1.7b", (2, 2, 2))],
                         ids=["recurrentgemma-2x2", "qwen3-2x2x2"])
def test_lower_cell_on_a_fake_mesh(arch, mesh):
    S = 64
    recs = _run(LOWER, arch, json.dumps(mesh), str(S), *KINDS, timeout=600)
    chips = 1
    for n in mesh:
        chips *= n
    for kind in KINDS:
        rec = recs[kind]
        assert rec["status"] == "OK", rec.get("error")
        assert RECORD_KEYS <= set(rec) and rec["n_chips"] == chips
        assert rec["multi_pod"] == (len(mesh) == 3)
        assert set(rec["collectives"]) == COLLECTIVE_KEYS
        wire = rec["collectives"]["wire_bytes"]
        assert wire > 0 and rec["roofline"]["collective_s"] == wire / roofline.NVLINK_BW
        assert "collectives=recorded" in rec["roofline"]["source"]
        if len(mesh) == 3 and kind == "train":  # the batch's gradients cross pods
            assert rec["collectives"]["cross_pod_wire_bytes"] > 0
        one = dryrun.dry_run(get_config(arch).reduced(),
                             ShapeConfig("reduced " + kind, S, 4, kind))
        ratio = rec["cost"]["flops"] * chips / one["cost"]["flops"]
        assert 1.0 <= ratio <= BOUND[kind], (kind, ratio)
        assert rec["analytic"]["flops_per_dev"] == rec["analytic"]["flops_global"] / chips
