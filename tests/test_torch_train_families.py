"""``chip_smoke.py``'s phase 3j on the CPU (its rehearsal: each family's
reduced config through ``launch.train.run``, the VLM and MoE cut in depth
through ``params``), the plain attention versions run a few heads at a
time (``per_heads``) against the whole, the recorder keeping a backward
pass's last call, the backward held at an image-prefix path's text
positions alone, and the reference's VLM stub pinned: zero image
embeddings stay zero rows through every layer, and at depth the gradient
through them overflows in the reference as in the port."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder as RefSharder
from repro.models.sharding import split_tree
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import lm
from repro_torch.train import make_loss_fn


@pytest.fixture
def chip_smoke(monkeypatch):
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def test_phase_3j_rehearsal(chip_smoke, capsys):
    """One line a path: three finite losses, every parameter's step-0
    gradient finite and non-zero, the table's depth (the MoE's 2 and the
    VLM's cut handed to ``run`` as a model), whisper over its published
    448-row table, each MoE layer routing every (token, choice) in step
    0; then each attention path's layer-0 forward held against the plain
    version, whisper's three kinds apart."""
    chip_smoke.train_families(torch.device("cpu"), chip_smoke.Recorder(), reduced=True)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    paths = {ln["check"]: ln for ln in lines if ln["check"] in chip_smoke.TRAIN_FAMILIES}
    assert list(paths) == list(chip_smoke.TRAIN_FAMILIES)
    for path, ln in paths.items():
        arch, _, _, layers = chip_smoke.TRAIN_FAMILIES[path]
        assert ln["arch"] == arch and ln["reduced"] and ln["steps"] == chip_smoke.TRAIN_STEPS
        assert all(math.isfinite(x) for x in ln["losses"])
        assert ln["step0_params_without_finite_nonzero_gradient"] == []
        assert ln["step0_params_with_gradient"] > 0
        if layers:
            assert ln["layers"] == layers != get_config(arch).reduced().n_layers
    assert paths["train audio"]["learned_positions"] == 448
    assert paths["train audio"]["enc_layers"] == 2
    moe = paths["train moe"]
    assert [sum(r) for r in moe["tokens_per_expert_step0"]] == [2 * 64 * 2] * 2
    held = [ln["check"] for ln in lines if ln["check"].endswith("flash_attention vs plain")]
    assert held == ["train moe flash_attention vs plain", "train vlm flash_attention vs plain",
                    "train audio flash_attention vs plain",
                    "train audio (cross) flash_attention vs plain",
                    "train audio (encoder) flash_attention vs plain"]
    assert lines[-1]["check"] == "train families phase"


def _attention_inputs(B=3, H=5, Sq=40, Sk=56, D=8, causal=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, n, D, generator=g) for n in (Sq, Sk, Sk, Sq))
    k_pos = torch.arange(Sk, dtype=torch.int32)
    q_pos = k_pos[Sk - Sq:] if causal else k_pos[:Sq]
    kw = dict(causal=causal, window=0)
    o = fa_ref.attention_ref(q, k, v, q_pos, k_pos, **kw)
    lse = fa_ref.lse_ref(q, k, q_pos, k_pos, **kw)
    return q, k, v, q_pos, k_pos, o, lse, do, kw


@pytest.mark.parametrize("scores", [1, 2 * 40 * 56, 1 << 27])
@pytest.mark.parametrize("causal", [False, True])
def test_per_heads_matches_the_whole(chip_smoke, monkeypatch, scores, causal):
    """One head, two heads (the last chunk short) or every head of a
    sequence at a time: the forward, its log-sum-exp and the backward
    equal the plain versions run whole."""
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORES_MAX", scores)
    q, k, v, q_pos, k_pos, o, lse, do, kw = _attention_inputs(causal=causal)
    split = chip_smoke.per_heads
    torch.testing.assert_close(split(fa_ref.attention_ref)(q, k, v, q_pos, k_pos, **kw), o,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(split(fa_ref.lse_ref)(q, k, q_pos, k_pos, **kw), lse,
                               atol=1e-6, rtol=1e-6)
    got = split(fa_ref.attention_bwd_ref)(q, k, v, q_pos, k_pos, o, lse, do, **kw)
    want = fa_ref.attention_bwd_ref(q, k, v, q_pos, k_pos, o, lse, do, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_kernel_case_untimed_by_head(chip_smoke, capsys):
    """``kernel_case`` on the CPU (the wrapper takes the plain version)
    without times: a ``main_path`` line holding the output, no times."""
    q, k, v, q_pos, k_pos, *_, kw = _attention_inputs(causal=True)
    row = chip_smoke.kernel_case("flash_attention", [q, k, v, q_pos, k_pos], kw, "t",
                                 recorded=True, by_head=True, timed=False)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["check"] == "t flash_attention vs plain" and line["by_head"]
    assert row["max_abs_err"] == 0.0 and "ms" not in row


def test_recorder_keeps_the_last_call_until_sealed(chip_smoke):
    class Mod:
        @staticmethod
        def f(x, **kw):
            return x

    rec = chip_smoke.Recorder()
    rec.tag = "p"
    rec.wrap(Mod, "f", "first")
    rec.wrap(Mod, "f", "last", last=True)
    for i in range(3):
        Mod.f(torch.tensor(float(i)))
    rec.sealed = True
    Mod.f(torch.tensor(9.0))
    assert float(rec.inputs[("first", "p")][0][0]) == 0.0
    assert float(rec.inputs[("last", "p")][0][0]) == 2.0
    rec.restore()
    assert not rec.sealed and Mod.f(1) == 1


def _vlm_batch(cfg):
    pipe = SyntheticLM(PipelineConfig(global_batch=2, seq_len=32, vocab_size=cfg.vocab_size,
                                      n_shards=1), seed=0)
    batch = dict(pipe.batch(0))
    batch["img_embeds"] = np.zeros((2, cfg.n_img_tokens, cfg.d_model), np.float32)
    return batch


@pytest.mark.parametrize("layers,finite", [(8, True), (24, False)])
def test_vlm_zero_image_prefix_gradients_match_reference(layers, finite):
    """``launch.train.run``'s VLM stub, the reference's: zero image
    embeddings.  Those rows stay exactly zero through every layer (they
    see only each other, and zero projects to zero), so RMSNorm scales
    their gradient by 1/sqrt(eps) at each norm; nothing reaches a weight
    from them (their activations are zero), but past some depth the
    gradient itself overflows and 0 x inf makes every gradient NaN.  The
    reduced config at 8 layers stays finite and at 24 does not, in the
    reference as in the port, whose gradients otherwise agree."""
    cfg = ref_config("phi-3-vision-4.2b").reduced().replace(n_layers=layers)
    pcfg = get_config("phi-3-vision-4.2b").reduced().replace(n_layers=layers)
    batch = _vlm_batch(cfg)
    params = split_tree(ref_lm.init(jax.random.PRNGKey(0), cfg, max_seq=64))[0]
    loss_fn = ref_steps.make_loss_fn(cfg, RefSharder(mesh=None))
    ref_grads = jax.grad(lambda p: loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        params)
    ref_finite = all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(ref_grads))
    model = lm.from_state_dict(pcfg, carry.lm_params_from_arrays(
        pcfg, jax.tree.map(np.asarray, params)), device="cpu").requires_grad_(True)
    rows = []
    model.layers[-1].register_forward_hook(lambda m, i, out: rows.append(out[0][:, :8]))
    total, _ = make_loss_fn(pcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert torch.count_nonzero(rows[0]) == 0  # the image rows after the last layer
    port_finite = all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert ref_finite == port_finite == finite
    if finite:
        want = carry.lm_params_from_arrays(pcfg, jax.tree.map(np.asarray, ref_grads))
        for name, p in model.named_parameters():
            w = want[name].to(p.grad.dtype)
            torch.testing.assert_close(p.grad, w, rtol=1e-4,
                                       atol=1e-4 * max(1.0, float(w.abs().max())), msg=name)


def test_text_rows_bwd_sees_what_a_whole_output_limit_lets_through(chip_smoke, monkeypatch):
    """An image prefix whose output gradient is huge (as the zero image
    rows' is at depth) sets a whole output's limit; a 1% error in the text
    keys' dV passes that limit but not ``text_rows_bwd``'s, and the sound
    backward passes both."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    n_img = 8
    q, k, v, q_pos, k_pos, o, lse, do, kw = _attention_inputs(B=2, H=3, Sq=40, Sk=40,
                                                              causal=True)
    do[:, :, :n_img] *= 1e20
    args = [q, k, v, q_pos, k_pos, o, lse, do]
    out = chip_smoke.text_rows_bwd("t", args, kw, n_img)
    assert out["plain"]["max_abs_err"] == 0.0 and "bf16_ref" not in out
    sound = fa_ops.flash_attention_bwd

    def faulty(*a, **k):
        dq, dk, dv = sound(*a, **k)
        dv = dv.clone()
        dv[:, :, n_img:] *= 1.01
        return dq, dk, dv

    want = fa_ref.attention_bwd_ref(*args, **kw)[2]
    lim = chip_smoke.scaled(chip_smoke.BWD_TOL[torch.float32], want)
    assert torch.allclose(faulty(*args, **kw)[2], want, **lim)  # the whole output's limit
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", faulty)
    with pytest.raises(SystemExit, match="text positions"):
        chip_smoke.text_rows_bwd("t", args, kw, n_img)
