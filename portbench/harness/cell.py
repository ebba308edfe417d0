"""One cell's run: set-up, the measured window, and the output check.

``ServeCell`` drives the program's serving path (``LM.prefill``, whose
last-token logits it keeps, and ``LM.decode_step`` through
``repro_torch.train.make_serve_step``), ``TrainCell`` its training step
(``make_train_step`` with AdamW).  Both load the benchmark's weights
into the program's model, and make every input from the seed on the
device.  After the window the program's state is freed and the
reference is run over a sample of what the window produced (``check``).
The weights and the reference are the configuration's reference module
(``cell.reference``; ``reference.lm`` unless the configuration file names
another, ``harness.spec``).

``fault`` plants one fault in the timed path, for the tests that show the
check catches it: ``"token"`` alters each served token where it is
produced, ``"one_row"`` alters the last row's served tokens alone,
``"half_batch"`` leaves half of the batch out (its outputs are copies of
the other half's; in training the loss is the mean over the first half),
``"frozen"`` makes the training step leave the parameters as they were.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import adamw as ref_adamw

def _seed(seed: int, tag: int, index: int) -> int:
    return (int(seed) * 7_777_777 + tag * 1_000_003 + (index + 1) * 104_729 + 17) % (2 ** 63)


def _generator(seed: int, tag: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(seed, tag, index))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_model(ref, cfg, m: dict, seed: int, device, dtype: torch.dtype):
    """The program's model with the benchmark's weights (those of the
    reference module ``ref``): built empty by the program, then filled a
    block at a time."""
    from repro_torch.models import lm
    from repro_torch.models.common import Init

    model = lm.LM(cfg, Init(None, dtype, torch.device(device))).eval()
    params = dict(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in params.items()}
    want = ref.leaves(m)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the program's parameters differ from the configuration's: {diff[:8]}")
    with torch.no_grad():
        for b in range(ref.n_blocks(m)):
            for name, t in ref.draw_block(m, seed, b, dtype, device).items():
                params[name].copy_(t)
    return model


def leaf_errs(diff: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's ``diff``, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    names = [k for k in ref if keep(k)]
    med = float(np.median([ref[k] for k in names]))
    return {k: diff[k] / max(ref[k], med) for k in names}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap between two norms (``leaf_errs``)."""
    return leaf_errs({k: abs(prog[k] - ref[k]) for k in ref}, ref, keep)


def worst_rel(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values())


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    requests: int = 0  # requests (serving) or steps (training) completed
    failed: int = 0
    tokens_in: int = 0
    tokens_out: int = 0
    gaps: List[float] = dataclasses.field(default_factory=list)  # decode token gaps, s
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # program counters


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return dict(fa_ops.LAUNCHES)


class ServeCell:
    """Closed-loop serving: each request is ``batch`` prompts of
    ``prompt_len`` tokens, prefilled, then (``gen_tokens`` > 1) decoded
    greedily, every token copied to the host as it is made."""

    KEEP = 16  # the window's first requests whose logits are kept for the check

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, int(seed), device, fault
        t = cell.traffic
        self.B, self.S, self.G = t["batch"], t["prompt_len"], t["gen_tokens"]
        self.m, self.ref = cell.model, cell.reference
        self.dtype = getattr(torch, self.m["param_dtype"])

    def setup(self) -> None:
        from repro_torch.train import make_serve_step
        from harness.spec import port_config

        self.cfg = port_config(self.cell.config, self.ref)
        self.model = build_model(self.ref, self.cfg, self.m, self.seed, self.device, self.dtype)
        self.step = make_serve_step()
        self.kept: Dict[int, tuple] = {}
        self.kept_bytes = 0  # device bytes of the kept logits and expert choices
        with torch.inference_mode():
            # the cell's own shapes, once: a prefill and (with decoding) one
            # decode step, into the cache length of the cell's requests
            self.request(-1, gen=min(self.G, 2))
        sync(self.device)

    def prompts(self, r: int) -> torch.Tensor:
        g = _generator(self.seed, 1, r, self.device)
        return torch.randint(0, self.m["vocab_size"], (self.B, self.S), generator=g,
                             device=self.device, dtype=torch.int32)

    def _served(self, tok):
        if self.fault == "token":
            tok = (tok + 1) % self.m["vocab_size"]
        elif self.fault == "half_batch":
            h = self.B // 2
            tok = torch.cat([tok[:h], tok[:h]])[:self.B]
        elif self.fault == "one_row":
            tok = torch.cat([tok[:-1], (tok[-1:] + 1) % self.m["vocab_size"]])
        return tok

    def request(self, r: int, win: Optional[Window] = None, gen: Optional[int] = None) -> None:
        """Request ``r``: its tokens reach the host; in the window, its
        counts and gaps go to ``win``, and the first ``KEEP`` requests'
        tokens and logits, and the program's expert choices in the prefill,
        are kept.  ``gen`` cuts the tokens generated (the warm-up), the
        cache length staying the cell's."""
        keep = win is not None and r < self.KEEP
        G = self.G if gen is None else gen
        tokens = self.prompts(r)
        logits_kept = (torch.empty((self.B, self.G, self.model.embed.shape[0]),
                                   dtype=torch.float32, device=self.device) if keep else None)
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        routes: list = []
        with torch.profiler.record_function("pb:prefill"):
            if keep and self.m.get("n_experts"):
                with program_routes(routes):
                    logits, caches = self.model.prefill(tokens, cache_len=self.S + self.G + 8)
            else:
                logits, caches = self.model.prefill(tokens, cache_len=self.S + self.G + 8)
            tok = self._served(logits[:, -1].argmax(dim=-1).to(torch.int32))
            finite &= torch.isfinite(logits).all()
            if keep:
                logits_kept[:, 0] = logits[:, -1]
            out = [tok.cpu()]
        t_prev = time.perf_counter()
        for i in range(G - 1):
            with torch.profiler.record_function("pb:decode_step"):
                pos = torch.full((self.B,), self.S + i, dtype=torch.int32, device=self.device)
                tok, logits, caches = self.step(self.model, caches, tok[:, None], pos)
                tok = self._served(tok)
                finite &= torch.isfinite(logits).all()
                if keep:
                    logits_kept[:, i + 1] = logits[:, -1]
                out.append(tok.cpu())
            t = time.perf_counter()
            if win is not None:
                win.gaps.append(t - t_prev)
            t_prev = t
        del caches
        if win is not None:
            win.requests += 1
            win.failed += int(not bool(finite))
            win.tokens_in += self.B * self.S
            win.tokens_out += self.B * self.G
            if keep:
                self.kept[r] = (torch.stack(out, dim=1), logits_kept, routes)
                self.kept_bytes += sum(t.numel() * t.element_size() for t in [logits_kept] + routes)

    def window(self, seconds: float) -> Window:
        """Requests back to back until ``seconds`` have passed; the window
        ends when the request in flight then is complete."""
        win = Window()
        before = _launch_counts()
        with torch.inference_mode(), torch.profiler.record_function("pb:window"):
            t0 = time.perf_counter()
            r = 0
            while time.perf_counter() - t0 < seconds:
                self.request(r, win)
                r += 1
            sync(self.device)
            win.seconds = time.perf_counter() - t0
        after = _launch_counts()
        win.launches = {k: after[k] - before.get(k, 0) for k in after}
        return win

    def release(self) -> None:
        del self.model
        self.step = None

    def check(self, control: Optional[str] = None, probe=None) -> Dict[str, float]:
        """The numbers compared, over a sample of the kept requests drawn
        from the seed.  Of each served token: the gap by which its logit
        lies below the reference's best at its position; of each position:
        the largest difference between the program's logits and the
        reference's.  Both are taken over the standard deviation of the
        reference's logits there; ``gap`` and ``logit_err`` are the widest
        of them, and ``seq_err_median`` the median over the sequences (the
        mean of the middle two for an even count) of each one's widest of
        either.  In a prefill with experts the reference takes the
        program's expert choices (``reference.lm.Routing``), and
        ``route_gap`` is the widest route gap of those choices.
        ``control`` names a lower precision (``"fp8"``): the same numbers,
        read for the reference in that precision in the program's place,
        at the same prompts and tokens, the exact reference taking its
        expert choices.  ``probe``, a list, gets each sequence's widest gap
        and error."""
        ref = self.ref
        ref.exact()
        rng = np.random.RandomState(_seed(self.seed, 2, 0) % (2 ** 32))
        n = min(self.cell.limits["sample_requests"], len(self.kept))
        if n == 0:
            raise RuntimeError("the window finished no request to check")
        picks = sorted(rng.choice(sorted(self.kept), size=n, replace=False).tolist())
        m, dt, dev = self.m, self.dtype, self.device

        def block(i):
            return ref.draw_block(m, self.seed, i, dt, dev)

        gaps, errs, route_gaps = [], [], []
        for r in picks:
            served, prog, routes = self.kept[r]
            served = served.to(dev).long()
            seq = torch.cat([self.prompts(r).long(), served[:, :-1]], dim=1)
            at = range(self.S - 1, self.S + self.G - 1)
            follow = routes if routes and self.G == 1 else None
            if control is not None:
                own = ref.Routing() if follow is not None else None
                prog = ref.logits_at(m, block, seq, at, quant=control, routing=own)
                served = prog.argmax(dim=-1)
                follow = own.chosen if own is not None else None
            routing = ref.Routing(follow=follow) if follow is not None else None
            want = ref.logits_at(m, block, seq, at, routing=routing)
            route_gaps += routing.gaps if routing is not None else [0.0]
            std = want.std(dim=-1)
            best = want.max(dim=-1).values
            gaps.append((best - want.gather(-1, served[..., None])[..., 0]) / std)  # (B, G)
            errs.append((prog - want).abs().amax(dim=-1) / std)  # (B, G)
        gap, err = torch.cat(gaps), torch.cat(errs)
        if probe is not None:
            probe.append({"seq_gap": gap.amax(dim=1).tolist(), "seq_err": err.amax(dim=1).tolist()})
        return {"gap": float(gap.max()), "logit_err": float(err.max()),
                "route_gap": max(route_gaps),
                "seq_err_median": float(torch.quantile(torch.maximum(gap, err).amax(dim=1), 0.5))}


@contextlib.contextmanager
def program_routes(into: list):
    """While open, the expert choices (T, k) of every call of the
    program's router (``models.moe._route``) are appended to ``into``."""
    from repro_torch.models import moe as moe_mod

    route = moe_mod._route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        into.append(out[1])
        return out

    moe_mod._route = recorded
    try:
        yield into
    finally:
        moe_mod._route = route


class TrainCell:
    """Back-to-back training steps of ``batch`` rows of ``seq_len`` random
    tokens.  Set-up runs the first ``check_steps`` steps through the
    window's own step and feed, and keeps what the check compares: each
    step's loss, each parameter's first gradient as AdamW took it (from
    its first moment after step 1: its norm, and the gradient itself on
    the host), its expert choices in step 1, and its change after the
    steps."""

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, int(seed), device, fault
        t = cell.traffic
        self.B, self.S, self.n_check = t["batch"], t["seq_len"], t["check_steps"]
        self.o = t["optimizer"]
        self.m, self.ref = cell.model, cell.reference
        self.dtype = getattr(torch, self.m["param_dtype"])
        self.i = 0  # steps taken
        self.kept_bytes = 0  # what the check keeps is on the host

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        g = _generator(self.seed, 3, i, self.device)
        toks = torch.randint(0, self.m["vocab_size"], (self.B, self.S + 1), generator=g,
                             device=self.device, dtype=torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _feed(self, i: int) -> Dict[str, torch.Tensor]:
        b = self.batch(i)
        if self.fault == "half_batch":
            w = torch.zeros((self.B, self.S), dtype=torch.float32, device=self.device)
            w[:max(self.B // 2, 1)] = 1.0
            b["weights"] = w
        return b

    def setup(self) -> None:
        from repro_torch.optim import adamw
        from repro_torch.train import make_train_step
        from harness.spec import port_config

        self.cfg = port_config(self.cell.config, self.ref)
        self.model = build_model(self.ref, self.cfg, self.m, self.seed, self.device, self.dtype)
        self.model.train()
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.opt = adamw.init(self.params)
        self.step_fn = make_train_step(self.cfg, adamw.AdamWConfig(**self.o))
        if self.fault == "frozen":
            self.step_fn = _frozen(self.step_fn)
        self.losses: List[float] = []
        self.routes: list = []  # the program's expert choices in the first step
        for _ in range(self.n_check):
            if self.i == 0 and self.m.get("n_experts"):
                with program_routes(self.routes):
                    self.losses.append(self.step())
                self.routes = self.routes[:self.m["n_layers"]]  # the forward's, not remat's
            else:
                self.losses.append(self.step())
            if self.i == 1:
                scale = 1.0 / (1 - self.o["b1"])
                self.grad1 = {k: float(torch.linalg.vector_norm(v)) * scale
                              for k, v in self.opt["m"].items()}
                self.grad1_host = {k: (v * scale).cpu() for k, v in self.opt["m"].items()}
        self.delta = self._change(self.params)
        sync(self.device)

    def step(self) -> float:
        _, self.opt, metrics = self.step_fn(self.model, self.opt, self._feed(self.i))
        self.i += 1
        return float(metrics["total_loss"])

    def _change(self, params) -> Dict[str, float]:
        """Each parameter's distance from its first value, the first values
        drawn again from the seed."""
        out = {}
        with torch.no_grad():
            for b in range(self.ref.n_blocks(self.m)):
                for name, p0 in self.ref.draw_block(self.m, self.seed, b, self.dtype,
                                                    self.device).items():
                    out[name] = float(torch.linalg.vector_norm(params[name].float() - p0.float()))
        return out

    def window(self, seconds: float) -> Window:
        win = Window()
        before = _launch_counts()
        finite = True
        with torch.profiler.record_function("pb:window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with torch.profiler.record_function("pb:train_step"):
                    loss = self.step()
                finite &= math.isfinite(loss)
                win.requests += 1
                win.failed += int(not math.isfinite(loss))
                win.tokens_in += self.B * self.S
            sync(self.device)
            win.seconds = time.perf_counter() - t0
        after = _launch_counts()
        win.launches = {k: after[k] - before.get(k, 0) for k in after}
        return win

    def release(self) -> None:
        del self.model, self.params, self.opt, self.step_fn

    def check(self, control: Optional[str] = None, probe=None) -> Dict[str, float]:
        """The reference trains the same weights on the same batches for
        the same steps.  The numbers compared: the worst step's loss gap
        over the reference's loss (``loss``); by leaf, the gap between the
        first gradients' norms (``grad1``), the norm of the first
        gradients' difference (``grad1_err``) and the gap between the
        parameters' changes' norms (``change``), each over the reference's
        norm of that leaf or of the median leaf, whichever is larger: the
        worst leaf's and the median leaf's (``*_median``).  In its first
        step the reference takes the program's expert choices (the
        reference module's ``Routing``); ``route_gap`` is their widest route
        gap.  Leaves whose reference gradient is under a thousandth of the
        median leaf's are left out (round-off alone moves them under
        AdamW).  ``control`` names a lower precision: the same numbers for
        the reference in that precision in the program's place.  ``probe``,
        a list, gets every leaf's readings."""
        self.ref.exact()
        if control is None:
            prog = {"losses": self.losses, "grad1": self.grad1, "delta": self.delta,
                    "grad1_host": self.grad1_host, "routes": self.routes}
        else:
            prog = self._reference(control, keep=True)
        ref = self._reference(None, against=prog.pop("grad1_host"), follow=prog["routes"])
        med = float(np.median(list(ref["grad1"].values())))

        def moved(k):
            return ref["grad1"][k] >= 1e-3 * med

        g = leaf_gaps(prog["grad1"], ref["grad1"], moved)
        e = leaf_errs(ref["grad1_diff"], ref["grad1"], moved)
        c = leaf_gaps(prog["delta"], ref["delta"], moved)
        if probe is not None:
            probe.append({"grad1_gaps": g, "grad1_errs": e, "change_gaps": c,
                          "ref_grad1": ref["grad1"],
                          "left_out": sorted(k for k in ref["grad1"] if not moved(k))})
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        return {"loss": loss, "grad1": max(g.values()), "grad1_err": max(e.values()),
                "change": max(c.values()), "route_gap": max(ref["route_gaps"], default=0.0),
                "grad1_median": float(np.median(list(g.values()))),
                "grad1_err_median": float(np.median(list(e.values()))),
                "change_median": float(np.median(list(c.values())))}

    def _reference(self, quant: Optional[str], against=None, keep: bool = False,
                   follow=None) -> dict:
        """The reference's steps (in ``quant``): its losses, first gradients'
        norms and changes' norms, its first step's expert choices
        (``routes``) and route gaps; the first step takes the choices
        ``follow`` where given.  With ``against`` (name -> a first gradient
        on the host), each leaf's norm of the difference from it
        (``grad1_diff``); with ``keep``, its own first gradient on the host
        (``grad1_host``)."""
        m, dev, ref = self.m, self.device, self.ref
        params = {}
        for b in range(ref.n_blocks(m)):
            for name, t in ref.draw_block(m, self.seed, b, self.dtype, dev).items():
                params[name] = t.to(torch.float32).clone().requires_grad_(True)
        opt = ref_adamw.AdamW(self.o, params)
        out = {"losses": [], "routes": [], "route_gaps": []}
        for i in range(self.n_check):
            b = self.batch(i)
            routing = None
            if i == 0 and m.get("n_experts"):
                routing = ref.Routing(follow=follow or None)
                out["routes"], out["route_gaps"] = routing.chosen, routing.gaps
            total, _, _ = ref.loss(m, params, b["tokens"], b["labels"], quant, routing=routing)
            total.backward()
            grads = {k: p.grad for k, p in params.items()}
            if i == 0:
                clip = opt.clip_factor(grads)
                with torch.no_grad():
                    if against is not None:
                        out["grad1_diff"] = {
                            k: float(torch.linalg.vector_norm(
                                g * clip - against[k].to(dev, torch.float32)))
                            for k, g in grads.items()}
                    if keep:
                        out["grad1_host"] = {k: (g * clip).cpu() for k, g in grads.items()}
            norms = opt.step(params, grads)
            for p in params.values():
                p.grad = None
            out["losses"].append(float(total.detach()))
            if i == 0:
                out["grad1"] = norms
        out["delta"] = self._change(params)
        del params, opt
        return out


def _frozen(step_fn):
    """The fault "frozen": the step runs, and the parameters and moments
    are put back as they were."""

    def step(model, opt, batch):
        saved = {k: p.detach().clone() for k, p in model.named_parameters()}
        m = {k: v.clone() for k, v in opt["m"].items()}
        v = {k: t.clone() for k, t in opt["v"].items()}
        model, opt, metrics = step_fn(model, opt, batch)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(saved[k])
        opt["m"], opt["v"] = m, v
        return model, opt, metrics

    return step


CELLS = {"prefill": ServeCell, "decode": ServeCell, "train": TrainCell}
