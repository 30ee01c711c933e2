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


def _loaded(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return [l for l in out.stdout.splitlines() if l.startswith("LOADED:")]


def test_one_eval_loads_neither_jax_nor_reference():
    assert _loaded(_ONE_EVAL) == ["LOADED:"]


_SPINE = r"""
import sys, time
from nomad_tpu_torch import mock
from nomad_tpu_torch.core.server import Server, ServerConfig
s = Server(ServerConfig(num_schedulers=2), device="cpu")
s.start()
cfg = s.store.scheduler_config
cfg.preemption_config.service_scheduler_enabled = True
s.register_node(mock.node())
low = mock.job(priority=20)
low.task_groups[0].tasks[0].resources.cpu = 3500
s.register_job(low)
assert s.wait_for_idle(30)
high = mock.job(priority=70)
high.task_groups[0].tasks[0].resources.cpu = 3500
s.register_job(high)
assert s.wait_for_idle(30)
s.stop()
assert [a.desired_status for a in s.store.allocs_by_job("default", low.id)] == ["evict"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nomad_tpu" or m.startswith("nomad_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_server_spine_and_preemption_load_neither_jax_nor_reference():
    assert _loaded(_SPINE) == ["LOADED:"]


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


def test_scan_covers_the_spine_modules():
    scanned = {os.path.relpath(p, REPO) for p in _py_files()}
    for mod in ("core/server.py", "core/worker.py", "core/broker.py",
                "core/blocked.py", "core/plan_queue.py", "raft/fsm.py",
                "ops/preempt.py", "scheduler/preemption.py"):
        assert os.path.join("nomad_tpu_torch", mod) in scanned, mod


def test_preempt_wrapper_refuses_other_devices():
    from nomad_tpu_torch.ops import preempt as tk
    res = torch.zeros((8, 4, 4), device="meta")
    with pytest.raises(ValueError):
        tk.preempt_for_task_group(res, res[..., 0].int(), res[..., 0].bool(),
                                  res[:, 0], res[0, 0])


def test_scan_covers_the_bench_modules():
    scanned = {os.path.relpath(p, REPO) for p in _py_files()}
    for mod in ("bench.py", "telemetry.py", "parallel/stage_probe.py",
                "ops/stage_probe.py"):
        assert os.path.join("nomad_tpu_torch", mod) in scanned, mod


_PROBE = r"""
import sys
from nomad_tpu_torch import bench
from nomad_tpu_torch.parallel import stage_probe
ds = stage_probe.device_stages({"device_s": 1.0}, 64, iters=1,
                               fill_grid=16, device="cpu")
assert ds["dominant_stage"] in stage_probe.STAGES
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nomad_tpu" or m.startswith("nomad_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_bench_and_stage_probe_load_neither_jax_nor_reference():
    assert _loaded(_PROBE) == ["LOADED:"]


def test_stage_probe_wrappers_refuse_other_devices():
    from nomad_tpu_torch.ops import stage_probe as sp
    m = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError):
        sp.argmax(m.bool(), m, m[0])
    with pytest.raises(ValueError):
        sp.scatter(m[:, 0].int(), m[:, 0].int(), 4, m[:, :4], m[0, :4],
                   m[:, 0].int())
