"""``examples/train_lm_torch.py`` against ``examples/train_lm.py`` on the
CPU at ``--steps 6`` (a save after step 3, the crash at step 4, the
resume from that save): the reference runs through ``runpy.run_path``
(its globals are read), the port through ``main(device="cpu",
params=...)`` from the reference's own ``lm.init(PRNGKey(0))`` weights,
carried by ``repro_torch.carry.lm_params_from_arrays``.  Every loss,
the resumed step's included, within 1e-4 relative (float32); the saves,
the restored step and the failovers equal; every printed line but the
losses' digits the same.  ``qwen3-1.7b`` (the examples' default, with
qk-norm) and ``granite-3-8b``.  Without a card the default device
raises."""
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as ref_lm
from repro.models.sharding import split_tree
from repro_torch import carry
from repro_torch.configs import get_config as port_config

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4  # f32, chip_smoke.py's TRAIN_CARD_VS_CPU_RTOL
STEPS, SEQ = 6, 64


def _port():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-8b"])
def test_train_lm_matches_reference(arch, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--arch", arch, "--steps", str(STEPS)])
    ref = runpy.run_path(str(ROOT / "examples" / "train_lm.py"), run_name="__main__")
    ref_lines = capsys.readouterr().out.splitlines()
    cfg = get_config(arch).reduced()
    init = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(0), cfg, max_seq=4 * SEQ))[0])
    state = carry.lm_params_from_arrays(port_config(arch).reduced(), init)
    got = _port().main(device="cpu", arch=arch, steps=STEPS, params=state)
    lines = capsys.readouterr().out.splitlines()

    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
    assert got["steps"] == [0, 1, 2, 3, 4, 4, 5]
    assert got["restored_step"] == ref["restored"] == 3 == got["crash_at"] - 1
    assert got["n_saves"] == ref["ckpt"].storage_cost()["n_saves"] == 1
    assert got["saved_steps"] == [3]
    assert got["failovers"] == ref["ckpt"].store.stats.failovers > 0
    assert got["losses"][4] == got["losses"][5]  # the resumed step, bit for bit
    digits = str.maketrans("0123456789", "##########")
    assert [x.translate(digits) for x in lines] == [x.translate(digits) for x in ref_lines]


def test_train_lm_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _port().main()
