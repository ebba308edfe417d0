"""What the benchmark loads, in fresh interpreters: the harness and the
reference load no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is not
``repro``), the reference nothing of ``repro_torch``; without a card the
command exits with 2, names the missing device and prints no result."""
from __future__ import annotations

import json
import subprocess
import sys

from pbtiny import PORTBENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(REPO / 'src')!r}, {str(PORTBENCH)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_reference_package():
    top = _loaded("import run, harness.cell, harness.spans, harness.trace, harness.spec\n"
                  "from harness import spec; c = spec.load_cell('qwen2-7b.decode-4k')\n"
                  "spec.port_config(c.config, c.reference)")
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "repro_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import reference.lm, reference.adamw, reference.weights")
    assert not top & (FORBIDDEN | {"repro_torch"}), top


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(PORTBENCH / "run.py"), "--workload",
                          "qwen2-7b.decode-4k", "--seed", "5000000000", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_forbidden_names_are_compared_whole():
    import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.models.lm", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "jaxlib.xla", "numpy"]) == ["jaxlib", "repro"]
