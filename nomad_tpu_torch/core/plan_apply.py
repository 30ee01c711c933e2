"""Serialized plan applier (reference: nomad/plan_apply.go — planApply:71,
evaluatePlan:400, evaluatePlanPlacements:439, evaluateNodePlan:640,
applyPlan:204).

The single point where optimistic scheduler output meets ground truth:
every placement is re-validated against the latest committed state (the
incremental ClusterMatrix *is* that state, so validation is vectorized
array math instead of the reference's per-node EvaluatePool fan-out), nodes
that fail are partially rejected, and the surviving plans are committed to
the state store in coalesced indexed writes.

Lock discipline (the commit pipeline):
  * `_lock` covers ONLY evaluation ordering — the snapshot a plan is
    validated against plus its overlay registration must be atomic so
    plan N+1 sees plan N's accepted effects.
  * `_commit_lock` covers ONLY commit ordering — indexed store/FSM
    writes stay strictly sequential.
  * All per-plan Python work (diff flattening, alloc serialization into
    AppliedPlanResults, future resolution, ticket release) happens off
    both locks, on the background commit thread.
Plans drained together from the queue (`dequeue_batch`) are committed as
ONE batched write — one lock acquisition, one FSM apply, one index —
mirroring the reference's optimistic pipeline (plan_apply.go:71-178)
with coalescing layered on top.  `apply` is the synchronous one-plan
form the scheduler Harness uses.
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from nomad_tpu_torch.encode.matrixizer import comparable_vec, NUM_RESOURCE_DIMS

from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.state.store import AppliedPlanResults, StateStore
from nomad_tpu_torch.structs import Allocation, Node
from nomad_tpu_torch.structs.namespace import alloc_quota_usage, usage_add
from nomad_tpu_torch.structs.node import NodeStatus
from nomad_tpu_torch.structs.plan import Plan, PlanResult
from nomad_tpu_torch.telemetry import global_metrics


# plans coalesced per commit (one indexed write for the whole batch): a
# wave-aligned worker pool lands its plans nearly at once, so the batch
# is sized to swallow a full wave in one FSM apply
PLAN_BATCH = 64


class PlanApplier:
    """Serialized: one plan at a time, guarded by a lock (the reference
    serializes via the single planApply goroutine)."""

    def __init__(self, store: StateStore, commit_fn=None, device=None):
        self.store = store
        # the device of the schedulers whose plans this applies: their
        # engine (get_engine(device)) holds the plans' overlay tickets
        self.device = resolve_device(device)
        # commit_fn(AppliedPlanResults) -> index routes the commit through
        # the Raft/FSM write path (reference: applyPlan raft.Apply of an
        # ApplyPlanResultsRequest, plan_apply.go:204); None = direct store
        # write (the scheduler Harness mode, testing.go:180)
        self._commit_fn = commit_fn
        # called after a commit that evicted allocs (the preempted list);
        # the server creates PreemptionEvals here, outside the raft lock
        self.on_preempted = None
        self._lock = threading.Lock()
        self._commit_lock = threading.Lock()
        # pipelining overlay: accepted-but-not-yet-committed plan effects,
        # keyed by plan eval token/id (reference plan_apply.go:71-178
        # evaluates plan N+1 against a snapshot with plan N applied while
        # N's raft.Apply is still in flight)
        self._overlay_lock = threading.Lock()
        self._overlay: Dict[int, tuple] = {}
        self._overlay_seq = 0
        # (t0, t1) wall windows of each coalesced commit (the store or FSM
        # write); the bench intersects them with the engine's device
        # windows for commit_overlap_s.  Appended by the one commit thread
        # at a time; readers tolerate staleness.
        self.commit_windows = deque(maxlen=8192)
        self.stats = {"applied": 0, "rejected_nodes": 0, "partial": 0,
                      "pipelined": 0}

    # ------------------------------------------------------------- public

    def apply(self, plan: Plan) -> PlanResult:
        with self._lock:
            result = self._evaluate(plan)
            token = self._overlay_add(plan, result)
        # flatten + commit off the evaluation lock; the overlay entry
        # keeps the accepted effects visible to concurrent evaluations
        # until the store write lands
        try:
            self._commit(plan, result)
        finally:
            with self._overlay_lock:
                self._overlay.pop(token, None)
        return result

    def run_loop(self, queue, stop_event: threading.Event) -> None:
        """Leader plan-apply loop draining the PlanQueue.

        Pipelined (plan_apply.go:71-178): while batch N's commit (the
        FSM apply) is in flight on a background thread, batch N+1's
        plans are already being evaluated against committed state + the
        in-flight overlays.  Adjacent plans drained together coalesce
        into ONE indexed commit.  Commits stay strictly ordered — the
        next commit starts only after the previous one finishes."""
        commit_t: Optional[threading.Thread] = None
        while not stop_event.is_set():
            batch = queue.dequeue_batch(PLAN_BATCH, timeout=0.1)
            if not batch:
                continue
            staged: List[tuple] = []
            for pending in batch:
                try:
                    # snapshot BEFORE evaluating: if the commit finishes
                    # while _evaluate reads the double-counted window, an
                    # after-the-fact is_alive() check would skip the
                    # second look and let the stale rejection stand
                    commit_in_flight = (commit_t is not None
                                        and commit_t.is_alive())
                    t0 = _time.time()
                    result = self._evaluate(pending.plan)
                    global_metrics.measure_since("nomad.plan.evaluate", t0)
                    if commit_in_flight and \
                            self._result_rejected_something(pending.plan,
                                                            result):
                        # the in-flight commit's usage is counted twice
                        # (store write + its overlay entry) until it pops;
                        # a rejection in that window may be pure
                        # over-reservation — settle the commit and give
                        # the plan one clean second look before failing it
                        # back to the scheduler (a full eval recompute).
                        # Plans staged in THIS batch are overlay-only, so
                        # they are never double-counted.
                        commit_t.join()
                        self.stats["revalidated"] = \
                            self.stats.get("revalidated", 0) + 1
                        result = self._evaluate(pending.plan)
                    token = self._overlay_add(pending.plan, result)
                except Exception as e:            # noqa: BLE001
                    pending.future.set_exception(e)
                    if not pending.evaluated.done():
                        pending.evaluated.set_exception(e)
                    continue
                staged.append((pending, result, token))
                # the plan is validated and its overlay registered: a
                # pipelined submitter may continue scheduling off this
                # result while the durable commit is still in flight
                if not pending.evaluated.done():
                    pending.evaluated.set_result(result)
            if not staged:
                continue
            if commit_t is not None:
                commit_t.join()
                self.stats["pipelined"] += 1
            if len(staged) > 1:
                self.stats["coalesced"] = \
                    self.stats.get("coalesced", 0) + len(staged)
            commit_t = threading.Thread(
                target=self._commit_batch_and_resolve, args=(staged,),
                name="plan-commit", daemon=True)
            commit_t.start()
        if commit_t is not None:
            commit_t.join()

    @staticmethod
    def _result_rejected_something(plan: Plan, result: PlanResult) -> bool:
        want = sum(len(v) for v in plan.node_allocation.values())
        got = sum(len(v) for v in result.node_allocation.values())
        return got < want

    def _commit_batch_and_resolve(self, staged: List[tuple]) -> None:
        """Commit a batch of evaluated plans as ONE indexed write, then
        resolve every submitter's future.  All flattening/serialization
        happens here, off the evaluation lock; overlay entries pop only
        after the write lands (never a double-free window)."""
        try:
            entries = [(pending, result,
                        self._applied_for(pending.plan, result))
                       for pending, result, _token in staged]
            applied_list = [ap for _, _, ap in entries if ap is not None]
            index = None
            if applied_list:
                t0c = _time.time()
                with self._commit_lock:
                    if self._commit_fn is not None:
                        index = self._commit_fn(
                            applied_list if len(applied_list) > 1
                            else applied_list[0])
                    else:
                        index = self.store.latest_index + 1
                        self.store.upsert_plan_results_many(
                            index, applied_list)
                self.commit_windows.append((t0c, _time.time()))
            for pending, result, applied in entries:
                try:
                    self._post_commit(pending.plan, result, applied, index)
                    pending.future.set_result(result)
                except Exception as e:            # noqa: BLE001
                    pending.future.set_exception(e)
        except Exception as e:                    # noqa: BLE001
            from nomad_tpu_torch.parallel.engine import get_engine
            eng = get_engine(self.device)
            for pending, _result, _token in staged:
                if pending.future.done():
                    continue
                # a pipelined submitter continued off `evaluated` and
                # skipped its early ticket release — free the engine
                # overlay here so a failed commit never leaks phantom
                # usage (plans that reached _post_commit released theirs
                # already; complete_many is idempotent regardless)
                if eng is not None and pending.plan.engine_tickets:
                    eng.complete_many(pending.plan.engine_tickets)
                pending.future.set_exception(e)
        finally:
            with self._overlay_lock:
                for _pending, _result, token in staged:
                    self._overlay.pop(token, None)

    # ------------------------------------------------------------- overlay

    def _overlay_add(self, plan: Plan, result: PlanResult) -> int:
        """Record the accepted plan's usage/port effects so the next
        evaluation sees them before the commit lands."""
        cm = self.store.matrix
        used_delta: Dict[int, np.ndarray] = {}
        port_claim: Dict[int, Set[int]] = {}
        port_free: Dict[int, Set[int]] = {}
        for node_id, allocs in result.node_allocation.items():
            row = cm.row_of.get(node_id)
            if row is None:
                continue
            vec = np.zeros(NUM_RESOURCE_DIMS, np.float32)
            for a in allocs:
                vec += comparable_vec(a.comparable_resources())
                port_claim.setdefault(row, set()).update(_alloc_ports(a))
            used_delta[row] = used_delta.get(
                row, np.zeros(NUM_RESOURCE_DIMS, np.float32)) + vec
        # NOTE: stops/preemptions are deliberately NOT overlaid.  The
        # overlay lives until the commit thread pops it *after* the store
        # write, so during that window effects would be counted twice.
        # Double-counted placements only over-reserve (spurious rejection
        # -> scheduler retry, safe); double-counted frees would validate
        # overcommitting plans.  Untracked in-flight frees merely delay
        # reuse of the space by one commit.
        # The same asymmetry holds for the quota overlay below: accepted
        # placements of quota-governed namespaces count against the
        # budget until their commit pops; frees never do.
        quota_delta: Dict[str, Dict[str, int]] = {}
        governed: Dict[str, bool] = {}
        for allocs in result.node_allocation.values():
            for a in allocs:
                gov = governed.get(a.namespace)
                if gov is None:
                    ns_obj = self.store.namespace(a.namespace)
                    gov = governed[a.namespace] = \
                        ns_obj is not None and bool(ns_obj.quota)
                if gov:
                    usage_add(quota_delta.setdefault(a.namespace, {}),
                              alloc_quota_usage(a), +1)
        with self._overlay_lock:
            self._overlay_seq += 1
            token = self._overlay_seq
            self._overlay[token] = (used_delta, port_claim, port_free,
                                    quota_delta)
        return token

    def _overlay_views(self, cm):
        """(used, port_words) with any in-flight overlay applied.  Copies
        are taken under the store lock so a concurrent commit thread
        cannot tear the matrices mid-read."""
        with self._overlay_lock:
            if not self._overlay:
                return cm.used, cm.port_words
            with self.store._lock:
                used = cm.used.copy()
                port_words = cm.port_words.copy()
            for used_delta, port_claim, port_free, _qd in \
                    self._overlay.values():
                for row, vec in used_delta.items():
                    if row < used.shape[0]:
                        used[row] += vec
                for row, ports in port_claim.items():
                    for p in ports:
                        port_words[row, p >> 5] |= np.uint32(1 << (p & 31))
            return used, port_words

    # ------------------------------------------------------------- evaluate

    def _node_ok_for_placement(self, node: Optional[Node]) -> bool:
        """evaluateNodePlan's node-state gate (plan_apply.go:653-668)."""
        if node is None:
            return False
        if node.status in (NodeStatus.DOWN, NodeStatus.DISCONNECTED):
            return False
        # ineligible nodes reject new work at *scheduling* time; the applier
        # only rejects unsafe nodes (down/disconnected/draining), mirroring
        # the reference's check of Status and Drain but not eligibility
        return node.drain_strategy is None

    def _evaluate(self, plan: Plan) -> PlanResult:
        """Validate placements per node against committed state; drop
        failing nodes (partial commit) or everything for all_at_once."""
        store = self.store
        cm = store.matrix
        result = PlanResult()
        result.node_update = {k: list(v) for k, v in plan.node_update.items()}
        result.node_preemptions = {k: list(v) for k, v in plan.node_preemptions.items()}
        result.deployment = plan.deployment
        result.deployment_updates = list(plan.deployment_updates)

        # resources freed on each node by this plan's stops/preemptions
        freed: Dict[str, np.ndarray] = {}
        freed_ports: Dict[str, Set[int]] = {}
        for node_id, stops in list(plan.node_update.items()) + \
                list(plan.node_preemptions.items()):
            vec = np.zeros(NUM_RESOURCE_DIMS, np.float32)
            ports: Set[int] = set()
            for a in stops:
                live = store.alloc_by_id(a.id)
                src = live if live is not None else a
                if live is not None and live.terminal_status():
                    continue   # already free in committed state
                cr = src.comparable_resources()
                vec += comparable_vec(cr)
                ports.update(_alloc_ports(src))
            freed[node_id] = vec
            freed_ports[node_id] = ports

        # batched per-node validation — the reference fans this across an
        # EvaluatePool (plan_apply_pool.go); here it is ONE native call
        # over all touched nodes (nomad_tpu_torch.native.validate_plan)
        from nomad_tpu_torch import native as _native
        node_ids = list(plan.node_allocation.keys())
        g = len(node_ids)
        rows = np.full(g, -1, np.int32)
        demand = np.zeros((g, NUM_RESOURCE_DIMS), np.float32)
        freed_vecs = np.zeros((g, NUM_RESOURCE_DIMS), np.float32)
        group_ports: List[List[int]] = []
        group_freed: List[List[int]] = []
        for i, node_id in enumerate(node_ids):
            node = store.node_by_id(node_id)
            row = cm.row_of.get(node_id)
            ports: List[int] = []
            if self._node_ok_for_placement(node) and row is not None:
                rows[i] = row
            for a in plan.node_allocation[node_id]:
                cr = a.comparable_resources()
                demand[i] += comparable_vec(cr)
                ports.extend(_alloc_ports(a))
            freed_vecs[i] = freed.get(node_id, 0.0)
            group_ports.append(ports)
            group_freed.append(sorted(freed_ports.get(node_id, ())))
        used_eff, port_words_eff = self._overlay_views(cm)
        ok = _native.validate_plan(
            cm.capacity, used_eff, port_words_eff, rows, demand,
            freed_vecs, group_ports, group_freed) if g else []

        rejected: List[str] = []
        # csi write-claim exclusion across concurrent plans (the reference
        # rejects the claim at the state store, csi.go ClaimWrite; here the
        # serialized applier is the authority): (ns, vol) -> job ids that
        # claimed a write in THIS plan evaluation
        pending_writers: Dict[Tuple[str, str], Set[str]] = {}
        for i, node_id in enumerate(node_ids):
            if ok[i] and not self._csi_claims_ok(
                    plan.node_allocation[node_id], pending_writers):
                ok[i] = False
            if ok[i] and not self._device_claims_ok(
                    plan, node_id, plan.node_allocation[node_id]):
                ok[i] = False
        for i, node_id in enumerate(node_ids):
            if ok[i]:
                result.node_allocation[node_id] = \
                    list(plan.node_allocation[node_id])
            else:
                rejected.append(node_id)
                # a victim is evicted only with the placement that
                # preempts it: a rejected node's preemptions leave the
                # result with its placements, as in the reference
                # scheduler's evaluatePlanPlacements (plan_apply.go).
                # The JAX package keeps them (ROADMAP.md queue C).
                result.node_preemptions.pop(node_id, None)

        # namespace quota admission at propose time, in the same
        # placement order the FSM will apply (node_allocation insertion
        # order == _applied_for's flatten order), against committed
        # usage + the in-flight quota overlay − this plan's own frees.
        # The FSM re-checks authoritatively at apply (the leader-churn
        # backstop: two leaders can each propose within-budget plans
        # that only overflow combined); on a stable leader this check
        # is never more permissive than the FSM's, so a propose-admit
        # implies an apply-admit and the plan result stays truthful.
        quota_dropped = self._quota_filter(plan, result)

        if (rejected or quota_dropped) and plan.all_at_once:
            # the reference nils updates, placements, preemptions AND the
            # deployment together when AllAtOnce fails (plan_apply.go:428-436)
            result.node_allocation = {}
            result.node_update = {}
            result.node_preemptions = {}
            result.deployment = None
            result.deployment_updates = []
        if rejected:
            result.rejected_nodes = rejected
            result.refresh_index = store.latest_index
            self.stats["partial"] += 1
            self.stats["rejected_nodes"] += len(rejected)
        return result

    def _quota_filter(self, plan: Plan, result: PlanResult) -> int:
        """Drop over-quota placements from the evaluated result.  Returns
        the number of placements dropped; sets
        ``result.quota_limit_reached`` to the exhausted spec's name so
        the scheduler blocks the eval keyed on it instead of retrying."""
        store = self.store
        # resolve the governing spec per namespace in the placements
        specs: Dict[str, object] = {}
        for allocs in result.node_allocation.values():
            for a in allocs:
                if a.namespace in specs:
                    continue
                ns_obj = store.namespace(a.namespace)
                spec = None
                if ns_obj is not None and ns_obj.quota:
                    spec = store.quota_spec(ns_obj.quota)
                specs[a.namespace] = spec
        if not any(spec is not None for spec in specs.values()):
            return 0

        # working view: committed usage + in-flight overlays − this
        # plan's frees (live, non-terminal stops only — same condition
        # as the resource `freed` vectors above)
        view: Dict[str, Dict[str, int]] = {}

        def usage(ns: str) -> Dict[str, int]:
            got = view.get(ns)
            if got is None:
                got = view[ns] = store.quota_usage(ns)
            return got

        with self._overlay_lock:
            overlay_qd = [entry[3] for entry in self._overlay.values()]
        for qd in overlay_qd:
            for ns, vec in qd.items():
                if specs.get(ns) is not None:
                    usage_add(usage(ns), vec, +1)
        for stops in list(plan.node_update.values()) + \
                list(plan.node_preemptions.values()):
            for a in stops:
                live = store.alloc_by_id(a.id)
                if live is None or live.terminal_status():
                    continue
                if specs.get(live.namespace) is not None:
                    usage_add(usage(live.namespace),
                              alloc_quota_usage(live), -1)

        dropped = 0
        for node_id in list(result.node_allocation.keys()):
            kept: List[Allocation] = []
            for a in result.node_allocation[node_id]:
                spec = specs.get(a.namespace)
                if spec is None or store.alloc_by_id(a.id) is not None:
                    # ungoverned namespace, or an update of an existing
                    # alloc (the FSM admits those unconditionally too)
                    kept.append(a)
                    continue
                would = dict(usage(a.namespace))
                usage_add(would, alloc_quota_usage(a), +1)
                if spec.admits(would):
                    view[a.namespace] = would
                    kept.append(a)
                else:
                    dropped += 1
                    result.quota_limit_reached = spec.name
            if dropped and len(kept) != len(result.node_allocation[node_id]):
                if kept:
                    result.node_allocation[node_id] = kept
                else:
                    del result.node_allocation[node_id]
        if dropped:
            self.stats["quota_dropped"] = \
                self.stats.get("quota_dropped", 0) + dropped
        return dropped

    def _csi_claims_ok(self, allocs: List[Allocation],
                       pending_writers: Dict[Tuple[str, str], Set[str]]
                       ) -> bool:
        """Write-claim feasibility for a node's placements: existing write
        claims may only be held by the same job (the checker's own
        exception, feasible.go:336-358 — covers destructive updates);
        write claims taken earlier in this same plan pass by another job
        reject the node."""
        for a in allocs:
            job = a.job
            tg = job.lookup_task_group(a.task_group) if job else None
            if tg is None:
                continue
            for req in tg.volumes.values():
                if req.type != "csi" or req.read_only:
                    continue
                key = (job.namespace, req.source)
                vol = self.store.csi_volume_by_id(*key)
                if vol is None:
                    return False
                others = pending_writers.get(key, set()) - {job.id}
                if others:
                    return False
                if not vol.has_free_write_claims():
                    for alloc_id in vol.write_claims:
                        holder = self.store.alloc_by_id(alloc_id)
                        if holder is None or \
                                holder.namespace != job.namespace or \
                                holder.job_id != job.id:
                            return False
                pending_writers.setdefault(key, set()).add(job.id)
        return True

    def _device_claims_ok(self, plan: Plan, node_id: str,
                          allocs: List[Allocation]) -> bool:
        """Device instance exclusivity at commit (the reference's
        DeviceAccounter collision check, structs/devices.go): the plan's
        placements must not claim instance ids already held by live
        allocs on the node (minus the plan's own stops/evictions) or by
        each other."""
        wanted: Dict[str, Set[str]] = {}
        any_dev = False
        for a in allocs:
            for tr in a.allocated_resources.tasks.values():
                for d in tr.devices:
                    any_dev = True
                    gid = f"{d['vendor']}/{d['type']}/{d['name']}"
                    ids = set(d.get("device_ids", []))
                    if ids & wanted.get(gid, set()):
                        return False          # duplicate within the plan
                    wanted.setdefault(gid, set()).update(ids)
        if not any_dev:
            return True
        dropped = {a.id for a in plan.node_update.get(node_id, [])}
        dropped |= {a.id for a in plan.node_preemptions.get(node_id, [])}
        for live in self.store.allocs_by_node(node_id):
            if live.terminal_status() or live.id in dropped:
                continue
            for tr in live.allocated_resources.tasks.values():
                for d in tr.devices:
                    gid = f"{d['vendor']}/{d['type']}/{d['name']}"
                    if set(d.get("device_ids", ())) & wanted.get(gid, set()):
                        return False
        return True

    # ------------------------------------------------------------- commit

    @staticmethod
    def _applied_for(plan: Plan,
                     result: PlanResult) -> Optional["AppliedPlanResults"]:
        """Flatten an evaluated plan into its raft payload; None for a
        no-op plan (nothing to write)."""
        if (not result.node_allocation and not result.node_update
                and not result.node_preemptions and result.deployment is None
                and not result.deployment_updates):
            return None
        if result.deployment is not None:
            # stamp here (propose side) so the FSM applies carried values
            # instead of reading the clock under fsm.apply
            d = result.deployment
            d.modify_time = _time.time()
            if not d.create_time:
                d.create_time = d.modify_time
        return AppliedPlanResults(
            alloc_updates=[a for v in result.node_update.values() for a in v],
            allocs_to_place=[a for v in result.node_allocation.values() for a in v],
            allocs_preempted=[a for v in result.node_preemptions.values() for a in v],
            deployment=result.deployment,
            deployment_updates=result.deployment_updates,
            eval_id=plan.eval_id,
            plan_id=getattr(plan, "plan_id", ""),
        )

    def _post_commit(self, plan: Plan, result: PlanResult,
                     applied: Optional["AppliedPlanResults"],
                     index: Optional[int]) -> None:
        """Per-plan bookkeeping after the store write: release the
        scheduler's in-flight overlay tickets NOW — the usage just became
        committed state, and any window where both the store and the
        overlay count it makes concurrent kernels see phantom usage."""
        if plan.engine_tickets:
            from nomad_tpu_torch.parallel.engine import get_engine
            eng = get_engine(self.device)
            if eng is not None:
                eng.complete_many(plan.engine_tickets)
        if applied is None:
            return
        result.alloc_index = index
        self.stats["applied"] += 1
        if applied.allocs_preempted and self.on_preempted is not None:
            try:
                self.on_preempted(applied.allocs_preempted)
            except Exception:                  # noqa: BLE001
                pass

    def _commit(self, plan: Plan, result: PlanResult) -> None:
        applied = self._applied_for(plan, result)
        index = None
        if applied is not None:
            with self._commit_lock:
                if self._commit_fn is not None:
                    index = self._commit_fn(applied)
                else:
                    index = self.store.latest_index + 1
                    self.store.upsert_plan_results(index, applied)
        self._post_commit(plan, result, applied, index)


def _alloc_ports(a: Allocation) -> List[int]:
    out = []
    for net in a.comparable_resources().networks:
        out += [p.value for p in net.reserved_ports if p.value]
        out += [p.value for p in net.dynamic_ports if p.value]
    out += [p.value for p in a.allocated_resources.shared_ports if p.value]
    return out
