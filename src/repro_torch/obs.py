"""The program's own spans and counters, for anyone who profiles it.

Both are live only while a ``torch.profiler`` records on the calling
thread (or on an autograd thread running its backward):

* ``span(name)`` records the host range ``hgs:<name>`` on the profiler's
  own clock, beside the device activity it launched.  It is an
  operator-scope record (``RecordFunctionFast``), not
  ``record_function``'s user scope: a user-scope range also draws a
  ``gpu_user_annotation`` over its kernels on the device's timeline,
  which a reader of the events without their activity types (torch
  2.11's ``_KinetoEvent`` has none) cannot tell from a kernel.  With no
  profiler recording it is one shared ``nullcontext`` and nothing is
  recorded; the gate costs under 1 us on a CPU (an ungated
  ``record_function`` ~15 us).
* ``count(name, value)`` adds a Python int, or a tensor on any device,
  into the counter ``name``.  A tensor is summed on its own device, with
  no synchronisation; ``counters()`` copies the sums to the host, once,
  after the profiled work.

Spans:

* ``hgs:serve_step`` — ``train.steps.make_serve_step``'s step, whole.
* ``hgs:decode_mha`` — ``models.attention._decode_mha`` (and
  ``_decode_range``, a rank's range of a slot-sharded cache): decode
  attention over the cache; on the card the ``decode_attention`` kernel's
  launch and its scratch, on the CPU its plain version (heads expanded,
  float32 casts, both products, mask and softmax).
* ``hgs:moe.dispatch`` — ``models.moe.moe_forward``'s dispatch, experts
  and combine; ``hgs:moe.experts`` — the expert products nested in it.

Counters (``models.moe.moe_forward``, on one device: a mesh's DTensors
are not counted; a layer recomputed under ``remat="full"`` counts again,
so ratios hold):

* ``moe.routed`` — the (token, choice) pairs routed.
* ``moe.dropped`` — per expert, the pairs that found its slots full.
* ``moe.slots`` — the expert slots computed (groups x experts x capacity).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Union

import torch

_NONE = contextlib.nullcontext()
_HOST: Dict[str, int] = {}
_DEVICE: Dict[str, torch.Tensor] = {}


def recording() -> bool:
    """Whether a profiler records on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler range ``hgs:<name>`` while one records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast("hgs:" + name)
    return _NONE


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Adds ``value`` into the counter ``name`` while a profiler records.
    A tensor's sum stays on its device, outside autograd, and is never an
    inference tensor, so counts from serving and from training add up."""
    if not torch.autograd._profiler_enabled():
        return
    if not isinstance(value, torch.Tensor):
        _HOST[name] = _HOST.get(name, 0) + int(value)
        return
    with torch.inference_mode(False), torch.no_grad():
        acc = _DEVICE.get(name)
        if acc is None:
            _DEVICE[name] = value.detach().clone()
        else:
            acc.add_(value.detach())


def counters() -> Dict[str, Union[int, float, list]]:
    """Every counter on the host: an int, or a tensor counter's sums as a
    number or a list."""
    out: Dict[str, Union[int, float, list]] = dict(_HOST)
    out.update({k: v.tolist() for k, v in _DEVICE.items()})
    return out


def reset() -> None:
    _HOST.clear()
    _DEVICE.clear()
