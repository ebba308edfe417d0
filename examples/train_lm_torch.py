"""End to end on the PyTorch port: train an assigned architecture
(reduced by default) on random walks over the temporal graph — the graph
plane feeding the LM plane — with TGI-backed delta checkpointing, a
simulated crash, and a resume.

The loop, its inputs and its printed lines are ``examples/train_lm.py``'s
on ``repro_torch``: ``GraphWalkLM`` over a port ``TGI``, the port's
``make_train_step`` and AdamW, a save every 4 steps to a
``CheckpointStore`` over a 4-node r=2 store, a crash at two thirds of
the steps with storage node 1 killed, and the restore of the latest save
into the model's parameters.  On the card the attention layers train
through the ``flash_attention`` kernels, forward and backward.
``--device`` defaults to the CUDA card and raises without one.

  PYTHONPATH=src python examples/train_lm_torch.py [--arch granite-3-8b] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.tgi import TGI, TGIConfig
from repro_torch.data.pipeline import GraphWalkLM, PipelineConfig
from repro_torch.data.temporal_graph_gen import generate
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.storage.checkpoint import CheckpointConfig, CheckpointStore
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.train import make_train_step


def main(device=None, arch: str = "qwen3-1.7b", steps: int = 24, batch: int = 8,
         seq: int = 64, reduced: bool = True, params=None) -> dict:
    """Train ``steps`` steps of ``arch`` (its reduced config unless
    ``reduced=False``) on ``device``.  ``params``: a state dict of the
    weights to start from (default: drawn from seed 0).  Returns the
    losses (a resumed step's loss is appended again), the steps they
    belong to, the saves, the failovers and the seconds each part took."""
    dev = resolve(device)  # no card and no device given: raise before any work
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    print(f"arch {arch} ({'reduced' if reduced else 'full'}): "
          f"{cfg.n_layers}L d={cfg.d_model}")

    # --- graph plane: history + index + walk dataset
    events = generate(6_000, seed=3)
    tgi = TGI.build(events, TGIConfig(n_shards=2, parts_per_shard=2,
                                      events_per_span=2_000),
                    DeltaStore(m=2, r=1, backend="mem"), device=dev)
    pipe = GraphWalkLM(PipelineConfig(batch, seq, cfg.vocab_size), tgi, seed=0)
    print("pipeline: random walks over TGI snapshots at "
          f"{len(pipe.times)} timepoints")

    # --- LM plane
    model = (lm.init(cfg, seed=0, device=dev, max_seq=4 * seq) if params is None
             else lm.from_state_dict(cfg, params, device=dev))
    model.train()
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    opt_state = adamw.init(named)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=4, decay_steps=steps)
    step_fn = make_train_step(cfg, ocfg)

    ckpt = CheckpointStore(DeltaStore(m=4, r=2, backend="mem"),
                           CheckpointConfig(snapshot_every=3))

    def extra_inputs(step):
        out = {}
        if cfg.n_img_tokens:
            out["img_embeds"] = np.zeros((batch, cfg.n_img_tokens, cfg.d_model), np.float32)
        if cfg.is_encdec:
            out["frames"] = (np.random.RandomState(step)
                             .randn(batch, cfg.enc_seq, cfg.d_model).astype(np.float32) * 0.02)
        return out

    crash_at = steps * 2 // 3
    crashed = False
    losses, ran, step_seconds, save_seconds = [], [], [], []
    restore_seconds, restored = None, None
    step = 0
    while step < steps:
        batch_np = dict(pipe.batch(step), **extra_inputs(step))
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(
            model, opt_state, {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()})
        losses.append(float(metrics["loss"]))  # waits for the step
        step_seconds.append(time.perf_counter() - t0)
        ran.append(step)
        if step % 4 == 0:
            print(f"step {step:3d} loss {losses[-1]:.4f}")
        if (step + 1) % 4 == 0:
            t0 = time.perf_counter()
            ckpt.save(step, (named, opt_state))
            save_seconds.append(time.perf_counter() - t0)
        if step == crash_at and not crashed:
            crashed = True
            print(f"--- simulated crash after step {step}; killing storage node 1 "
                  "and restoring from replicas ---")
            ckpt.store.fail_node(1)
            t0 = time.perf_counter()
            (params_r, opt_state), restored = ckpt.restore(c=4, example_tree=(named, opt_state))
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(params_r[k])
            del params_r
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restore_seconds = time.perf_counter() - t0
            step = restored + 1
            print(f"--- resumed from step {restored} (failovers: "
                  f"{ckpt.store.stats.failovers}) ---")
            continue
        step += 1

    cost = ckpt.storage_cost()
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"checkpoint store wrote {cost['bytes_written']/1e6:.1f} MB "
          f"across {cost['n_saves']} saves "
          f"(delta saves compress vs snapshots)")
    assert losses[-1] < losses[0], "training should reduce loss"
    print("OK")
    return dict(arch=arch, reduced=reduced, n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_params=sum(p.numel() for p in named.values()), losses=losses, steps=ran,
                crash_at=crash_at, restored_step=restored,
                failovers=int(ckpt.store.stats.failovers), n_saves=cost["n_saves"],
                bytes_written=cost["bytes_written"], saved_steps=[e["step"] for e in ckpt.saves],
                step_seconds=step_seconds, save_seconds=save_seconds,
                restore_seconds=restore_seconds)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    main(args.device, args.arch, args.steps)
