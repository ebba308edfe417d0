"""End-to-end training loop (port of ``repro.launch.train``): the LM,
AdamW, the deterministic pipeline and the TGI checkpoint store (periodic
async saves, restore on start).

Weights are random, drawn on the device from ``seed``, unless ``params``
carries them (the reference draws its own with ``jax.random``, so a test
carries those over with ``repro_torch.carry.lm_params_from_arrays``).
Batches are ``SyntheticLM(seed)``'s, the same tokens as the reference's,
with the reference's stub inputs: a VLM's image embeddings as zeros, an
encoder-decoder's frames from ``np.random.RandomState(step)``.
``device=None`` means the CUDA card and raises without one; there the
attention and RG-LRU layers train through their backward kernels.
``shd`` (a ``models.sharding.Sharder`` over a DeviceMesh) trains the
model sharded: its parameters become DTensors (``Sharder.distribute``),
each rank takes its chunk of every batch (``specs.batch_shardings``) and
the kernels run on each rank's block; it saves whole tensors, and does
not resume (``CheckpointStore.restore_sharded`` places a save on a mesh).

  python -m repro_torch.launch.train --device cpu          # reduced qwen3-1.7b
  python -m repro_torch.launch.train --steps 30 --checkpoint-every 10   # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.device import DeviceLike, resolve
from repro_torch.launch import specs
from repro_torch.models import lm
from repro_torch.models.sharding import NO_SHD, Sharder, place
from repro_torch.optim import adamw
from repro_torch.storage.checkpoint import CheckpointStore
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.train import make_train_step


def _model(cfg, params, seed: int, dev: torch.device, max_seq: int) -> lm.LM:
    """The model to train: random from ``seed`` (``max_seq`` rows of
    learned positions), ``params`` itself (an ``lm.LM`` of ``cfg`` or of
    ``cfg`` with fewer layers, a depth cut), or ``cfg``'s model loaded
    from the state dict ``params``."""
    if params is None:
        return lm.init(cfg, seed=seed, device=dev, max_seq=max_seq)
    if isinstance(params, lm.LM):
        if params.cfg.replace(n_layers=cfg.n_layers) != cfg:
            raise ValueError(f"params are a model of {params.cfg.name} that differs from the "
                             f"config of the run in more than its depth")
        return params
    return lm.from_state_dict(cfg, params, device=dev)


def run(arch: str = "qwen3-1.7b", steps: int = 30, batch: int = 8, seq: int = 64,
        reduced: bool = True, checkpoint_every: int = 0, resume: bool = False,
        store: Optional[CheckpointStore] = None, seed: int = 0, log_every: int = 5,
        lr: float = 1e-3, stop_after: Optional[int] = None, *, device: DeviceLike = None,
        params=None, shd: Sharder = NO_SHD):
    """Train ``steps`` AdamW steps (or up to ``stop_after``), saving
    ``(parameters, optimizer state)`` to ``store`` every
    ``checkpoint_every`` steps and, with ``resume``, starting after the
    store's latest save.  Returns (model, optimizer state, losses)."""
    dev = resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = _model(cfg, params, seed, dev, max_seq=4 * seq)
    cfg = model.cfg
    model.train()
    model.requires_grad_(True)
    shd.distribute(model)
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    named = dict(model.named_parameters())
    opt_state = adamw.init(named)
    start_step = 0
    if resume and store is not None and store.saves:
        if shd.mesh is not None:
            raise ValueError("a sharded run does not resume here: place the saved state "
                             "with CheckpointStore.restore_sharded")
        (restored, opt_state), start_step = store.restore(example_tree=(named, opt_state))
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(restored[k])
        start_step += 1
        print(f"[resume] restored step {start_step - 1}")

    pipe = SyntheticLM(PipelineConfig(global_batch=batch, seq_len=seq,
                                      vocab_size=cfg.vocab_size, n_shards=1), seed=seed)
    step_fn = make_train_step(cfg, ocfg, shd)

    losses = []
    pending = None
    end = min(steps, stop_after) if stop_after is not None else steps
    for step in range(start_step, end):
        batch_np = pipe.batch(step)
        if cfg.n_img_tokens:
            batch_np["img_embeds"] = np.zeros((batch, cfg.n_img_tokens, cfg.d_model), np.float32)
        if cfg.is_encdec:
            batch_np["frames"] = (np.random.RandomState(step).randn(batch, cfg.enc_seq,
                                                                    cfg.d_model)
                                  .astype(np.float32) * 0.02)
        if shd.mesh is None:
            batch_t = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        else:
            placed = specs.batch_shardings(batch_np, shd)
            batch_t = {k: place(v, shd.mesh, placed[k], dev) for k, v in batch_np.items()}
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch_t)
        loss = float(metrics["loss"])  # waits for the step
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} dt {time.perf_counter() - t0:.2f}s")
        if checkpoint_every and store is not None and (step + 1) % checkpoint_every == 0:
            if pending is not None:
                pending.result()  # backpressure: at most one in flight
            pending = store.save_async(step, (named, opt_state))
    if pending is not None:
        pending.result()
    return model, opt_state, losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    store = None
    if args.checkpoint_every:
        backend = "file" if args.checkpoint_dir else "mem"
        store = CheckpointStore(
            DeltaStore(m=4, r=2, backend=backend, root=args.checkpoint_dir)
        )
    _, _, losses = run(args.arch, args.steps, args.batch, args.seq, True,
                       args.checkpoint_every, store=store, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
