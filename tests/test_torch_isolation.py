"""The port stands alone: it never imports JAX or the reference package,
and it never falls back to the CPU by itself."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nomad_tpu_torch")

_ONE_EVAL = r"""
import sys
from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.testing import Harness
h = Harness(device="cpu")
for _ in range(4):
    h.store.upsert_node(h.next_index(), mock.node())
job = mock.job()
job.task_groups[0].count = 3
h.store.upsert_job(h.next_index(), job)
ev = mock.eval(job_id=job.id, type=job.type)
h.store.upsert_evals(h.next_index(), [ev])
h.process("service", ev)
assert len(h.store.allocs_by_job("default", job.id)) == 3
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nomad_tpu" or m.startswith("nomad_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_one_eval_loads_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ONE_EVAL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("LOADED:")]
    assert line == ["LOADED:"], out.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, REPO)
                                        for p in _py_files()))
def test_no_jax_or_reference_import(path):
    for mod in _imports(os.path.join(REPO, path)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "nomad_tpu"), (path, mod)


def test_chip_smoke_imports_neither():
    for mod in _imports(os.path.join(REPO, "chip_smoke.py")):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "nomad_tpu"), mod


def test_harness_without_device_needs_cuda(monkeypatch):
    from nomad_tpu_torch.scheduler.testing import Harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Harness()
    with pytest.raises(RuntimeError, match="cuda"):
        Harness(device="cuda")
    assert Harness(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from nomad_tpu_torch.ops import place as tp
    cap = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        tp.place_bulk(cap, cap, None, None, False, 1, None, None, None, 1)


def test_scan_covers_the_engine_modules():
    scanned = {os.path.relpath(p, REPO) for p in _py_files()}
    for mod in ("knobs.py", "parallel/world.py", "parallel/engine.py"):
        assert os.path.join("nomad_tpu_torch", mod) in scanned, mod
