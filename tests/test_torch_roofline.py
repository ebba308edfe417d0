"""The port's roofline pieces against the reference's on the same inputs:
the analytic FLOP and byte model (a copy), the roofline at the H100's
peaks (equal to the reference's once each term is scaled back by its
peak), parameter counts of the ``meta`` models at full width, the batch
and cache stand-ins, and the sharding rule table's ``spec_for`` and
``n_kv_virtual`` over every parameter and cache leaf."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config as ref_config
from repro.launch import specs as ref_specs
from repro.models import lm as ref_lm
from repro.models import sharding as ref_sharding
from repro.models.common import Init as RefInit
from repro.roofline import analytic as ref_analytic
from repro.roofline import roofline as ref_roofline
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import sharding
from repro_torch.roofline import analytic, roofline

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
MESHES = [(16, 16), (2, 16, 16)]


def _mesh_axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_forward_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert analytic.param_counts(cfg) == ref_analytic.param_counts(rcfg)
    for B, S, Sk, cache in ((2, 4096, 0, 0), (3, 1000, 512, 0), (4, 1, 0, 32768)):
        assert analytic.forward_flops(cfg, B, S, Sk, cache) == \
            ref_analytic.forward_flops(rcfg, B, S, Sk, cache)
    assert analytic.slstm_scan_correction(cfg, 2, 4096) == \
        ref_analytic.slstm_scan_correction(rcfg, 2, 4096)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_flops_and_bytes_equal_the_reference(arch, shape):
    cfg, rcfg, sh = get_config(arch), ref_config(arch), SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    assert analytic.step_flops(cfg, sh.kind, B, S) == ref_analytic.step_flops(rcfg, sh.kind, B, S)
    assert analytic.step_bytes(cfg, sh.kind, B, S) == ref_analytic.step_bytes(rcfg, sh.kind, B, S)
    one = dict(dp=1, tp=1, chips=1)
    assert analytic.step_bytes(cfg, sh.kind, B, S, **one) == \
        ref_analytic.step_bytes(rcfg, sh.kind, B, S, **one)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_equals_the_reference_once_scaled_by_the_peaks(arch, shape):
    """The same cost dict (the cell's analytic FLOPs and one card's bytes,
    and some collective bytes) through both rooflines: each term times its
    own peak is the same work; the model FLOPs and useful ratio are equal;
    ``dominant`` is equal wherever the cell's arithmetic intensity is not
    between the two devices' ridge points."""
    cfg, sh = get_config(arch), SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    flops = analytic.step_flops(cfg, sh.kind, B, S)
    nbytes = analytic.step_bytes(cfg, sh.kind, B, S, dp=1, tp=1, chips=1)["total"]
    cost = {"flops": flops, "bytes accessed": nbytes}
    n = analytic.param_counts(cfg)
    tokens = B * S if sh.kind != "decode" else B
    mf = roofline.model_flops(sh.kind, int(n["stem"] + n["layers"]), tokens)
    assert mf == ref_roofline.model_flops(sh.kind, int(n["stem"] + n["layers"]), tokens)
    wire = 1e6
    got = roofline.compute_roofline(cost, wire, mf, 1)
    want = ref_roofline.compute_roofline(cost, wire, mf, 1)
    assert got.compute_s * roofline.PEAK_FLOPS == pytest.approx(
        want.compute_s * ref_roofline.PEAK_FLOPS, rel=1e-12)
    assert got.memory_s * roofline.HBM_BW == pytest.approx(
        want.memory_s * ref_roofline.HBM_BW, rel=1e-12)
    assert got.collective_s * roofline.NVLINK_BW == pytest.approx(
        want.collective_s * ref_roofline.ICI_BW, rel=1e-12)
    assert got.model_flops_per_dev == want.model_flops_per_dev
    assert got.hlo_flops_per_dev == want.hlo_flops_per_dev
    assert got.useful_ratio == want.useful_ratio
    assert got.step_time_s == max(got.compute_s, got.memory_s, got.collective_s)
    assert got.mfu == pytest.approx(mf / (got.step_time_s * roofline.PEAK_FLOPS), rel=1e-12)
    terms = {"compute": got.compute_s, "memory": got.memory_s, "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    ridges = sorted((roofline.PEAK_FLOPS / roofline.HBM_BW,
                     ref_roofline.PEAK_FLOPS / ref_roofline.HBM_BW))
    if not ridges[0] <= flops / nbytes <= ridges[1] and "collective" not in (
            got.dominant, want.dominant):
        assert got.dominant == want.dominant


def test_peaks_are_the_h100_data_sheet_figures():
    assert (roofline.PEAK_FLOPS, roofline.TF32_FLOPS, roofline.FP32_FLOPS,
            roofline.INT32_OPS) == (989e12, 495e12, 67e12, 33.5e12)
    assert (roofline.HBM_BW, roofline.NVLINK_BW) == (3.35e12, 450e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_model_counts_equal_the_reference_at_full_width(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    model = specs.abstract_params(cfg, max_seq=4096)
    assert all(p.device.type == "meta" for p in model.parameters())
    values, _ = ref_sharding.split_tree(ref_specs.abstract_params(rcfg, max_seq=4096))
    assert specs.n_params(model) == ref_specs.n_params(values)
    assert specs.n_active_params(cfg, model) == ref_specs.n_active_params(rcfg, values)
    opt = specs.abstract_opt_state(model)
    assert sum(v.numel() for v in opt["m"].values()) == specs.n_params(model)


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_decode_specs_match_the_reference(arch, shape):
    cfg, rcfg, sh = get_config(arch), ref_config(arch), SHAPES[shape]
    if sh.kind != "decode":
        got, want = specs.batch_specs(cfg, sh), ref_specs.batch_specs(rcfg, sh)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape) and _name(got[k].dtype) == _name(v.dtype)
            assert got[k].device.type == "meta"
        return
    for model_axis in (1, 16):
        caches, tok, pos = specs.decode_specs(cfg, sh, model_axis)
        rcache, rtok, rpos = ref_specs.decode_specs(rcfg, sh, model_axis)
        assert (tuple(tok.shape), tuple(pos.shape)) == (tuple(rtok.shape), tuple(rpos.shape))
        rvals, _ = ref_sharding.split_tree(rcache)
        # the reference's cache: the remainder layers, then the units stacked
        unit = rcfg.unit_len
        assert len(caches) == rcfg.n_layers
        for i, layer in enumerate(caches):
            if i < rcfg.n_rem_layers:
                ref_layer, strip = rvals["rem"][f"b{i}"], False
            else:
                ref_layer, strip = rvals["units"][f"b{(i - rcfg.n_rem_layers) % unit}"], True
            assert list(layer) == list(ref_layer)
            for kind, entries in layer.items():
                assert sorted(entries) == sorted(ref_layer[kind])
                for k, t in entries.items():
                    want = ref_layer[kind][k]
                    wshape = tuple(want.shape)[1:] if strip else tuple(want.shape)
                    assert (tuple(t.shape), _name(t.dtype)) == (wshape, _name(want.dtype)), \
                        (i, kind, k)
                    assert t.device.type == "meta"


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=ref_sharding.is_param_leaf)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_spec_for_equals_the_reference_on_every_leaf(arch, mesh):
    """Every parameter leaf (and every cache leaf of a decode_32k and a
    long_500k cache) of the reference's abstract model, under the default
    rules and the long-context overrides: the same greedy assignment."""
    rcfg = ref_config(arch)
    axes = _mesh_axes(mesh)
    ref_mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(mesh, dtype=np.int8))
    port_mesh = dict(zip(axes, mesh))
    leaves = _leaves(ref_lm.init(jax.random.PRNGKey(0), rcfg, max_seq=4096, abstract=True))
    ini = RefInit(rng=jax.random.PRNGKey(0), abstract=True)
    leaves += _leaves(ref_lm.init_cache(ini, rcfg, 128, 32768, mesh[-1]))
    leaves += _leaves(ref_lm.init_cache(ini, rcfg, 1, 524288, mesh[-1]))
    assert leaves and all(isinstance(p, ref_sharding.ParamLeaf) for p in leaves)
    for overrides in ({}, ref_sharding.LONG_CONTEXT_OVERRIDES):
        rrules = ref_sharding.make_rules(**overrides)
        rules = sharding.make_rules(**overrides)
        assert rules == rrules
        for p in leaves:
            want = tuple(ref_sharding.spec_for(p.value.shape, p.axes, rrules, ref_mesh))
            assert sharding.spec_for(p.value.shape, p.axes, rules, port_mesh) == want, p.axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_kv_virtual_equals_the_reference(arch):
    cfg = get_config(arch)
    for model_axis in (1, 2, 4, 8, 16, 32):
        for H, KV in ((cfg.n_heads, cfg.n_kv_heads), (cfg.n_heads_p, cfg.n_kv_p)):
            assert sharding.n_kv_virtual(H, KV, model_axis) == \
                ref_sharding.n_kv_virtual(H, KV, model_axis)


def test_split_tree_over_dicts_and_lists():
    a, b = torch.zeros(2, 3), torch.ones(4)
    tree = {"x": sharding.ParamLeaf(a, ("batch", None)),
            "ys": [sharding.ParamLeaf(b, ("embed",)), {"z": sharding.ParamLeaf(a, (None, "mlp"))}]}
    values, axes = sharding.split_tree(tree)
    assert values["x"] is a and values["ys"][0] is b and values["ys"][1]["z"] is a
    assert axes == {"x": ("batch", None), "ys": [("embed",), {"z": (None, "mlp")}]}
    assert sharding.is_param_leaf(tree["x"]) and not sharding.is_param_leaf(a)
