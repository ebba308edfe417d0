"""The port's logical-axis sharding against the reference's
(``repro.models.sharding``), on the CPU and without a process group:
every parameter's logical axes against the reference's ``lm.init`` leaves
(less the stacked "layers" axis), every parameter's ``spec_for`` on both
production meshes at full width, ``placements`` (the joint ("pod",
"data") batch included), and ``Sharder``'s no-ops without a mesh."""
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, get_config as ref_config
from repro.models import lm as ref_lm
from repro.models import sharding as ref_sharding
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
from repro_torch.models import sharding
from repro_torch.models.common import Init

MAX_SEQ = 64


def _ref_tree(cfg, max_seq=MAX_SEQ):
    return ref_sharding.split_tree(ref_lm.init(jax.random.PRNGKey(0), cfg, max_seq,
                                               abstract=True))


def _per_layer(value, unit):
    """A stacked leaf's per-layer part: its axes or its shape without the
    leading "layers" dimension."""
    return tuple(value)[1:] if unit is not None else tuple(value)


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_parameter_axes_are_the_references(arch):
    values, axes = _ref_tree(ref_config(arch).reduced())
    pcfg = get_config(arch).reduced()
    model = specs.abstract_params(pcfg, MAX_SEQ)
    got = sharding.param_axes(model)
    names = carry.lm_names(pcfg, values)
    assert got.keys() == names.keys()
    for name, (path, unit) in names.items():
        want = carry.lm_leaf(axes, path)
        if unit is not None:
            assert want[0] == "layers", (name, want)
        assert got[name] == _per_layer(want, unit), name
        assert len(got[name]) == dict(model.named_parameters())[name].dim()


@pytest.mark.parametrize("mesh", [SINGLE_POD, MULTI_POD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_full_width_specs_are_the_references(arch, mesh):
    """``spec_for`` of every parameter at full width; the reference reads
    only ``axis_names`` and ``devices.shape`` of its mesh."""
    shape, names = mesh
    stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    values, axes = _ref_tree(ref_config(arch), 4096)
    pcfg = get_config(arch)
    model = specs.abstract_params(pcfg, 4096)
    mesh_axes = dict(zip(names, shape))
    params = dict(model.named_parameters())
    for name, (path, unit) in carry.lm_names(pcfg, values).items():
        v, a = carry.lm_leaf(values, path), carry.lm_leaf(axes, path)
        want = tuple(ref_sharding.spec_for(v.shape, a, ref_sharding.DEFAULT_RULES, stand_in))
        if unit is not None:  # "layers" never shards: drop its None
            want = want[1:]
        p = params[name]
        assert tuple(p.shape) == _per_layer(v.shape, unit), name
        got = sharding.spec_for(p.shape, p.axes, sharding.DEFAULT_RULES, mesh_axes)
        assert got == want, (name, got, want)


def _mesh(names):
    return types.SimpleNamespace(mesh_dim_names=names)


def test_placements():
    two = _mesh(("data", "model"))
    assert sharding.placements((), two) == [Replicate(), Replicate()]
    assert sharding.placements(("data", "model"), two) == [Shard(0), Shard(1)]
    assert sharding.placements(("model", None, "data"), two) == [Shard(2), Shard(0)]
    assert sharding.placements((None, "model"), two) == [Replicate(), Shard(1)]
    three = _mesh(("pod", "data", "model"))
    # the joint batch entry shards dim 0 over both, in mesh order
    assert sharding.placements((("pod", "data"), None, "model"), three) == [
        Shard(0), Shard(0), Shard(2)]
    rules = sharding.DEFAULT_RULES
    spec = sharding.spec_for((256, 4096, 3584), ("batch", "res_seq", "act_embed"), rules,
                             dict(zip(*MULTI_POD[::-1])))
    assert spec == (("pod", "data"), "model")
    assert sharding.placements(spec, three) == [Shard(0), Shard(0), Shard(1)]
    # qwen2's 28 heads on a 16-wide model axis: head_dim takes it
    spec = sharding.spec_for((3584, 28, 128), ("embed", "heads", "head_dim"), rules,
                             dict(zip(*SINGLE_POD[::-1])))
    assert spec == ("data", None, "model")
    assert sharding.placements(spec, two) == [Shard(0), Shard(2)]


def test_sharder_without_a_mesh_is_a_no_op():
    shd = sharding.Sharder()
    x = torch.randn(2, 8, 4)
    assert shd.act(x, "batch", "res_seq", "act_embed") is x
    assert shd.model_axis == 1
    model = specs.abstract_params(get_config("qwen3-1.7b").reduced(), MAX_SEQ)
    before = dict(model.named_parameters())
    assert shd.distribute(model) is model
    assert dict(model.named_parameters()) == before
    with shd.scope():
        calls = []
        out = shd.local(lambda a, b, k=0: calls.append(k) or a + b, (x, x), (0,), k=3)
    assert calls == [3] and torch.equal(out, x + x)


def test_init_tags_every_parameter_with_its_axes():
    ini = Init(None, torch.float32, torch.device("meta"))
    p = ini.fan_in((8, 4, 2), ("embed", "heads", "head_dim"), fan_axes=(0,))
    assert p.axes == ("embed", "heads", "head_dim") and not p.requires_grad
    with pytest.raises(ValueError, match="axes"):
        ini.zeros((3, 3), ("embed",))
