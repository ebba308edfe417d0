"""The port stands alone: importing every repro_torch module loads no
jax and nothing of repro; no module of the port nor chip_smoke.py
imports either; and each module the port keeps as a verbatim copy still
equals its repro source after the ``repro.`` -> ``repro_torch.`` import
rewrite (an unintended edit of a copy fails here)."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIES = [
    "core/events.py", "core/slots.py", "core/partition.py", "core/timespan.py",
    "core/faultpoints.py", "core/delta.py", "core/version_chain.py",
    "core/ingest.py", "core/__init__.py", "storage/serialize.py",
    "storage/kvstore.py", "data/temporal_graph_gen.py", "taf/son.py",
    "taf/replay.py", "taf/operators.py", "taf/__init__.py",
    "configs/__init__.py", "configs/granite_3_8b.py", "configs/minitron_8b.py",
    "configs/mixtral_8x22b.py", "configs/phi3_5_moe_42b_a6_6b.py",
    "configs/phi_3_vision_4_2b.py", "configs/qwen2_7b.py", "configs/qwen3_1_7b.py",
    "configs/recurrentgemma_9b.py", "configs/whisper_small.py", "configs/xlstm_350m.py",
    "service/__init__.py", "service/wire.py", "service/cell.py", "service/client.py",
    "service/stress.py", "data/pipeline.py", "launch/elastic.py", "roofline/analytic.py",
]
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.strip().splitlines()
    assert int(n_modules) >= 25
    assert leaked == "[]"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# the multi-card modules, and the ranks of tests/test_torch_distributed.py
MULTI_CARD = ["repro_torch.launch.mesh", "repro_torch.models.sharding",
              "repro_torch.optim.compression", "repro_torch.roofline.collectives",
              "repro_torch.launch.dryrun", "repro_torch.taf.exec",
              "repro_torch.storage.checkpoint", "torch_dist_workers"]


def test_multi_card_modules_load_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MULTI_CARD!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
        "import torch.distributed as dist\n"
        "print(dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # no jax, no repro, and no module starts a process group on import
    assert out.stdout.split() == ["[]", "False"]


EXAMPLES = [ROOT / "examples" / f"{name}_torch.py"
            for name in ("quickstart", "temporal_analytics", "train_lm")]


def test_importing_the_examples_loads_no_jax_and_no_repro():
    code = (
        "import importlib.util, sys\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, *map(str, EXAMPLES)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + EXAMPLES
                         + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_has_not_drifted(rel):
    want = _IMPORT.sub(r"\1repro_torch.", (SRC / "repro" / rel).read_text())
    assert (PORT / rel).read_text() == want
