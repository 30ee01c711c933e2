"""The port's bench entry point (nomad_tpu_torch/bench.py) on the CPU.

`python -m nomad_tpu_torch.bench --smoke --device cpu` runs once for the
module: the C2M-1M shape shrunk to seconds through the dev-mode server,
then the scan-spread, device and preemption shapes shrunk.  It must
commit every alloc, sample plan.submit once per submitted plan, record
the applier's commit windows, and print one JSON line with the keys of
the reference's --smoke line (bench.py, read from its source: the
reference's run needs JAX's serving plane and tracer).
"""
import ast
import contextlib
import io
import json
import os

import pytest
import torch

from nomad_tpu import telemetry as rtel
from nomad_tpu_torch import bench, telemetry
from nomad_tpu_torch.core import server as tserver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_run():
    servers, enqueued = [], []
    real_server, real_enqueue = bench._server, tserver.Server.enqueue_plan

    def server(*a, **kw):
        s = real_server(*a, **kw)
        servers.append(s)
        return s

    def enqueue(self, plan):
        # a plan counts once the queue takes it (a superseded lease's
        # plan is refused here, and its submit samples nothing)
        pending = real_enqueue(self, plan)
        enqueued.append(plan)
        return pending

    basis = {}
    real_check = bench._check_basis

    def check_basis(s, eng, scenario, rec):
        real_check(s, eng, scenario, rec)
        basis.update(rec.basis_matches_host)

    # the process-wide series may hold samples of earlier tests' servers
    for name in ("nomad.plan.submit", "nomad.plan.evaluate"):
        telemetry.global_metrics.take_sample(name)
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "_server", server)
    mp.setattr(tserver.Server, "enqueue_plan", enqueue)
    mp.setattr(bench, "_check_basis", check_basis)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--smoke", "--device", "cpu"])
    finally:
        mp.undo()
    return dict(rc=rc, stdout=out.getvalue(), servers=servers,
                enqueued=enqueued, basis=basis)


def _line(run):
    lines = run["stdout"].splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _reference_dict_keys(marker):
    """Keys of the dict literal in the reference's bench.py that holds
    the string constant `marker` (its JSON lines)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(v, ast.Constant) and v.value == marker
                for v in node.values):
            return {k.value for k in node.keys}
    raise AssertionError(f"no dict with {marker!r} in bench.py")


def test_smoke_commits_every_alloc(smoke_run):
    assert smoke_run["rc"] == 0
    line = _line(smoke_run)
    assert line["placed"] == line["want"] == 30 * 5 * 4
    assert line["value"] > 0
    assert line["steady_state"]["violations"] == []
    assert line["steady_state"]["steady_reuploads"] == 0
    assert line["fused"]["violations"] == []
    assert line["fused"]["bulk_parts"] == line["fused"]["bulk_groups"] > 0
    # the complete window went idle with the device basis equal to the
    # world's host snapshot (a miss would be a steady-state violation)
    assert smoke_run["basis"] == {"smoke": True}


def test_plan_submit_sampled_once_per_submitted_plan(smoke_run):
    line = _line(smoke_run)
    stats = line["plan_latency_ms"]
    assert set(stats) == {"smoke", "scan_spread", "device", "preemption"}
    total = sum(s["submit_ms"]["count"] for s in stats.values())
    assert total == len(smoke_run["enqueued"]) > 0, stats
    for s in stats.values():
        assert s["submit_ms"]["count"] > 0
        assert s["evaluate_ms"]["count"] > 0
        assert 0 < s["submit_ms"]["p50"] <= s["submit_ms"]["p99"]


def test_applier_records_commit_windows(smoke_run):
    assert len(smoke_run["servers"]) == 4
    for s in smoke_run["servers"]:
        wins = list(s.applier.commit_windows)
        assert wins
        assert all(t0 <= t1 for t0, t1 in wins)


def test_smoke_line_has_the_reference_keys(smoke_run):
    line = _line(smoke_run)
    assert set(line) == _reference_dict_keys("c2m_smoke_allocs_per_sec")
    assert set(line["steady_state"]) == _reference_dict_keys("disallow")
    assert set(line["fused"]) == {"bulk_groups", "bulk_parts", "kernels",
                                  "violations"}
    # JAX's transfer guard, recompile budget and jit caches, the serving
    # plane and the tracing leg have no counterpart in the port
    assert line["serving_plane"] is None and line["tracing"] is None
    assert line["fused"]["kernels"] is None
    assert line["steady_state"]["transfer_guard"] is None
    ds = line["device_stages"]
    assert ds is not None and ds["n_nodes"] == 128 and ds["fill_grid"] == 16
    assert sum(ds["stages_s"].values()) == pytest.approx(ds["device_s"],
                                                         abs=1e-5)


def test_headline_line_has_the_reference_keys(monkeypatch):
    """The headline's line, with every scenario stubbed out: the
    reference's headline keys plus placed/want and the fused check."""
    def fail(*a, **kw):
        raise RuntimeError("stubbed")
    for name in ("bench_c2m_1m", "bench_kernel_c2m_scale",
                 "bench_kernel_100k_nodes"):
        monkeypatch.setattr(bench, name, fail)
    line, violations = bench.headline(device="cpu")
    ref = _reference_dict_keys("c2m_1m_allocs_per_sec_10knodes_1mallocs")
    assert ref <= set(line)
    assert set(line) - ref == {"placed", "want", "fused", "tracing"}
    assert line["value"] == 0.0 and line["device_stages"] is None
    # every failed scenario and the missing probe are violations, so
    # the entry point exits 1
    for name in ("c2m_1m", "kernel_c2m_scale", "kernel_100k_nodes"):
        assert f"scenario {name} failed" in violations
    assert "stage probe: no device_stages" in violations


@pytest.mark.parametrize("flag", ["--fleet-soak", "--matrix"])
def test_multi_server_modes_are_not_ported(flag):
    with pytest.raises(NotImplementedError, match="A6"):
        bench.main([flag, "--device", "cpu"])


def test_take_sample_equals_the_reference():
    ours, ref = telemetry.MetricsRegistry(), rtel.MetricsRegistry()
    vals = [((k * 7919) % 2003) / 7.0 for k in range(3000)]
    for v in vals:
        ours.add_sample("nomad.plan.submit", v)
        ref.add_sample("nomad.plan.submit", v)
    assert ours.take_sample("nomad.plan.submit") == \
        ref.take_sample("nomad.plan.submit")
    # taking resets the series
    assert ours.take_sample("nomad.plan.submit") == \
        ref.take_sample("nomad.plan.submit")
    assert ours.take_sample("nomad.plan.submit")["count"] == 0


SCENARIOS = {
    "e2e_spine": lambda rec: bench.bench_e2e_spine(
        n_nodes=64, n_jobs=4, count=10, workers=4, device="cpu", rec=rec),
    "dev_agent": lambda rec: bench.bench_dev_agent_sim(device="cpu",
                                                       rec=rec),
    "c2m": lambda rec: bench.bench_c2m(
        n_nodes=128, n_batch=3, batch_count=40, n_service=2,
        service_count=10, workers=4, device="cpu", rec=rec),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_other_scenarios_commit_on_the_cpu(name):
    """The BASELINE scenarios the smoke run does not reach, shrunk: each
    commits what it asked for and records its plan latency."""
    rec = bench.Record()
    assert SCENARIOS[name](rec) > 0
    if name != "dev_agent":          # it asserts its 6 allocs itself
        got = rec.allocs[name]
        assert got["placed"] == got["want"] > 0
    assert rec.plan_stats[name]["submit_ms"]["count"] > 0

