"""The harness's spans around the program's layers, for a traced run.

``installed()`` wraps, for as long as it is open, the module functions
through which the program's model calls each layer:

* ``pb:attn`` — ``models.attention.attention_forward`` (prefill, training)
* ``pb:attn_decode`` — ``models.attention.attention_decode``
* ``pb:moe`` — ``models.moe.moe_forward``
* ``pb:adamw`` — ``optim.adamw.update``

A wrapped call runs inside ``record_function("pb:<what>")``.  Where it
records a gradient, its first tensor argument and output also pass
through an identity whose backward marks ``pb:<what>:bwd<`` (on the
output: the layer's backward starts) and ``pb:<what>:bwd>`` (on the
input: it ends), so ``harness.trace`` counts the backward's kernels too.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

TARGETS = (("repro_torch.models.attention", "attention_forward", "attn"),
           ("repro_torch.models.attention", "attention_decode", "attn_decode"),
           ("repro_torch.models.moe", "moe_forward", "moe"),
           ("repro_torch.optim.adamw", "update", "adamw"))


class _Mark(torch.autograd.Function):
    """Identity; its backward records a zero-length range ``label``."""

    @staticmethod
    def forward(ctx, label, t):
        ctx.label = label
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with record_function(ctx.label):
            pass
        return None, g


def _marked(label: str, t):
    if isinstance(t, torch.Tensor) and t.requires_grad and torch.is_grad_enabled():
        return _Mark.apply(label, t)
    return t


def _wrap(fn, what: str):
    name = f"pb:{what}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args = list(args)
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                args[i] = _marked(f"{name}:bwd>", a)
                break
        with record_function(name):
            out = fn(*args, **kwargs)
        if isinstance(out, tuple) and out and isinstance(out[0], torch.Tensor):
            return (_marked(f"{name}:bwd<", out[0]),) + out[1:]
        return _marked(f"{name}:bwd<", out)

    return wrapped


@contextlib.contextmanager
def installed():
    import importlib

    saved = []
    try:
        for mod_name, attr, what in TARGETS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, _wrap(getattr(mod, attr), what))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
