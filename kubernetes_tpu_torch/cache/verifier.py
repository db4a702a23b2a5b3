"""Resident-state invariant checker.

Counterpart of ``kubernetes_tpu/cache/verifier.py`` over the port's
resident cluster (``engine/solver.py:ResidentCluster``), whose wide
planes read back with no decode step.

The device-residency protocol keeps three copies of the
cluster's resource truth: the tracked pod objects (`SchedulerCache`
state machine), the incrementally-maintained host aggregates
(`NodeAggregates`, mutated in place by assume/forget/heartbeat deltas),
and the device-resident tensors (`ResidentCluster`, patched by dirty-row
scatters).  A bug anywhere in that delta pipeline silently skews
placements — the failure mode a churn soak
would surface.  This module turns that class of bug into a COUNTER
instead of a wrong placement: a low-frequency background pass
cross-checks

* ``aggregates`` — the live aggregate rows vs a from-scratch recompute
  out of the tracked pod set (the delta pipeline's ground truth);
* ``device_row`` — a sampled row set read back from the device-resident
  tensors vs the host arrays, valid only when the mirror claims to be in
  sync (same epoch + shape signature) and the rows carry no pending
  dirty deltas;
* ``apiserver`` — the cache's pod placements vs one apiserver relist,
  with a grace re-read so watch-delivery lag (bind landed, confirm not
  yet pumped) never counts as a violation.

Each mismatch increments
``scheduler_cache_invariant_violations_total{kind=}`` and SELF-HEALS by
forcing a full re-snapshot (``force_resnapshot`` + mirror invalidation:
the next drain rebuilds every tensor from the tracked objects and
re-uploads, epoch-bumped) — plus, for apiserver drift, re-adopting
missing bound pods and dropping ghosts.  The soak harness runs it
throughout and holds the count at 0.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.utils import locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("verifier")

# Rows sampled per device readback pass (one gather per field).
DEFAULT_SAMPLE = 64
# Second look delay for apiserver mismatches: longer than watch delivery
# lag under load, far shorter than any real drift's lifetime.
APISERVER_GRACE_S = 0.5


@dataclass
class Violation:
    kind: str      # aggregates | device_row | apiserver | defrag
    detail: str

    def __str__(self) -> str:  # pragma: no cover — logging sugar
        return f"[{self.kind}] {self.detail}"


class Verifier:
    """Background cross-checker over one cache (+ optional device mirror
    and apiserver truth source).  ``truth`` is a zero-arg callable
    returning the apiserver's pod dicts (the factory passes
    ``lambda: store.list("pods")[0]``).  ``streams``, where given, is a
    zero-arg callable naming the pod watch streams that feed the cache
    (None while one is down and its reflector waits to relist): the
    apiserver check counts a mismatch only when the same streams were
    open from the first truth read to the grace re-read, since a
    reflector between streams has not seen the deletes and binds of
    that window yet (the factory passes its pod reflectors' tokens)."""

    def __init__(self, cache: object, resident: object = None,
                 truth: Optional[Callable[[], list]] = None,
                 sample: int = DEFAULT_SAMPLE, heal: bool = True,
                 grace_s: float = APISERVER_GRACE_S, seed: int = 0,
                 streams: Optional[Callable[[], object]] = None):
        self.cache = cache
        self.resident = resident
        self.truth = truth
        self.streams = streams
        # Apiserver checks left inconclusive: a pod stream was down or
        # restarted inside the window.
        self.relisting_skips = 0
        self.sample = sample
        self.heal = heal
        self.grace_s = grace_s
        self._rng = np.random.RandomState(seed)
        self._stop = threading.Event()
        self.passes = 0
        self.violations_total = 0
        # Pods whose defrag migration just settled (scheduler/defrag.py
        # arms these via note_defrag): the next pass runs the ``defrag``
        # reconciliation kind over them — cache placement and aggregates
        # must already reflect the moves.
        self._defrag_pending: set[str] = set()
        self._defrag_lock = locktrace.make_lock("cache.Verifier.defrag")

    # -- the three checks ------------------------------------------------

    def _check_aggregates(self) -> list[Violation]:
        """Live aggregate rows vs a from-scratch recompute.  Runs under
        the cache lock so the recompute and the live rows are one
        generation."""
        out: list[Violation] = []
        with self.cache.lock:
            req_ref, nz_ref = self.cache.recompute_aggregates()
            agg = self.cache._agg
            for name, live, ref in (("requested", agg.requested, req_ref),
                                    ("nonzero", agg.nonzero, nz_ref)):
                if np.array_equal(np.asarray(live), np.asarray(ref)):
                    continue
                bad = np.nonzero(
                    (np.asarray(live) != np.asarray(ref)).any(axis=-1)
                    if np.asarray(live).ndim > 1 else
                    np.asarray(live) != np.asarray(ref))[0][:8]
                nodes = [self.cache._node_order[i] for i in bad.tolist()]
                out.append(Violation(
                    "aggregates",
                    f"{name} rows diverged from recompute at "
                    f"{len(bad)}+ node(s), e.g. {nodes}"))
        return out

    def _check_device_rows(self) -> list[Violation]:
        """Sampled device-resident rows vs the host arrays — the
        dirty-row scatter protocol's observable contract.  Rows with
        pending (un-synced) dirty deltas are excluded; a mirror awaiting
        a full re-upload (epoch/signature moved) is legitimately stale
        and skipped entirely."""
        if self.resident is None:
            return []
        out: list[Violation] = []
        with self.cache.lock:
            self.cache._ensure_tensors()
            nt, agg = self.cache._nt, self.cache._agg
            n = len(self.cache._node_order)
            if n == 0 or not self.resident.in_sync(
                    nt, self.cache.space, self.cache.tensor_epoch):
                return []
            clean = np.setdiff1d(
                np.arange(n),
                np.fromiter(self.cache._dirty_rows, np.int64,
                            len(self.cache._dirty_rows)))
            if clean.size == 0:
                return []
            k = min(self.sample, clean.size)
            idx = self._rng.choice(clean, size=k, replace=False)
            dev = self.resident.readback_rows(idx)
            host = {"schedulable": np.asarray(nt.schedulable)[idx],
                    "alloc": np.asarray(nt.alloc)[idx],
                    "requested": np.asarray(agg.requested)[idx],
                    "nonzero": np.asarray(agg.nonzero)[idx]}
            for field in host:
                if np.array_equal(np.asarray(dev[field]), host[field]):
                    continue
                diff = np.asarray(dev[field]) != host[field]
                bad = np.nonzero(diff.reshape(k, -1).any(axis=1))[0][:8]
                nodes = [self.cache._node_order[int(idx[i])]
                         for i in bad.tolist()]
                out.append(Violation(
                    "device_row",
                    f"resident {field} rows diverged from host at "
                    f"node(s) {nodes}"))
        return out

    def _placements_snapshot(self) -> tuple[int, dict, dict]:
        """(generation, confirmed {key: node}, assumed {key: node})."""
        with self.cache.lock:
            gen = self.cache.generation
            confirmed, assumed = {}, {}
            for key, node, is_assumed in self.cache.tracked_pods():
                (assumed if is_assumed else confirmed)[key] = node
        return gen, confirmed, assumed

    def _apiserver_mismatches(self, items: list[dict]) -> list[str]:
        """Mismatch descriptions for one truth snapshot, or [] — also []
        when the cache moved while the truth was being fetched (the
        generation guard: churn races are not violations)."""
        gen0, confirmed, assumed = self._placements_snapshot()
        mismatches: list[str] = []
        truth_bound: dict[str, str] = {}
        for obj in items:
            key = api.key_from_json(obj)
            node = (obj.get("spec") or {}).get("nodeName") or ""
            if node and not api.is_terminated_json(obj):
                truth_bound[key] = node
        gen1, confirmed1, _ = self._placements_snapshot()
        if gen1 != gen0:
            return []  # cache moved mid-fetch: retry next pass
        for key, node in truth_bound.items():
            have = confirmed.get(key) or assumed.get(key)
            if have is None:
                mismatches.append(f"bound pod {key} (on {node}) missing "
                                  f"from the cache")
            elif have != node:
                mismatches.append(f"pod {key} cached on {have} but bound "
                                  f"to {node} at the apiserver")
        for key, node in confirmed.items():
            if key not in truth_bound:
                mismatches.append(f"cache ghost: confirmed pod {key} "
                                  f"(on {node}) has no apiserver record")
        return mismatches

    def _check_apiserver(self) -> list[Violation]:
        if self.truth is None:
            return []
        streams0 = self.streams() if self.streams is not None else None
        try:
            first = self._apiserver_mismatches(self.truth())
        except Exception:  # noqa: BLE001 — an unreachable truth is not drift
            return []
        if not first:
            return []
        # Grace re-read: watch-delivery lag (a bind landed, the confirm
        # event not yet pumped) resolves within the grace window; real
        # drift does not.
        if self._stop.wait(self.grace_s):
            return []
        try:
            second = self._apiserver_mismatches(self.truth())
        except Exception:  # noqa: BLE001
            return []
        if self.streams is not None and (
                streams0 is None or self.streams() != streams0):
            # A pod stream was down or relisted inside the window: its
            # reflector is still catching up, which is lag, not drift.
            self.relisting_skips += 1
            return []
        persistent = sorted(set(first) & set(second))
        return [Violation("apiserver", m) for m in persistent]

    def note_defrag(self, keys: Iterable[str]) -> None:
        """Arm the ``defrag`` reconciliation kind for settled migrations:
        the next pass confirms cache placement and aggregate rows
        reflect the moves (a scatter that missed an eviction delta shows
        up here as a counted violation, not a skewed placement)."""
        with self._defrag_lock:
            self._defrag_pending.update(keys)

    def _check_defrag(self) -> list[Violation]:
        """Post-migration reconciliation over the armed key set: each
        rebound migrant's cache attachment must match apiserver truth,
        and the aggregate rows must survive a from-scratch recompute
        (re-labeled ``defrag`` so a soak can pin migration-settle
        integrity separately from steady-state drift)."""
        with self._defrag_lock:
            if not self._defrag_pending:
                return []
            keys, self._defrag_pending = self._defrag_pending, set()
        out: list[Violation] = []
        if self.truth is not None:
            try:
                items = self.truth()
            except Exception:  # noqa: BLE001 — unreachable truth: re-arm
                self.note_defrag(keys)
                return []
            truth_node = {}
            for obj in items:
                truth_node[api.key_from_json(obj)] = \
                    (obj.get("spec") or {}).get("nodeName") or ""
            suspect: list[tuple[str, str]] = []
            for key in sorted(keys):
                node = truth_node.get(key)
                if not node:
                    continue  # deleted, or re-evicted: nothing to confirm
                tracked = self.cache.get_pod(key)
                have = getattr(tracked, "node_name", None)
                if have != node and not self.cache.is_assumed(key):
                    suspect.append((key, node))
            if suspect and not self._stop.wait(self.grace_s):
                # Grace re-check: the confirm event for a just-landed
                # re-bind may still be in the watch pipe — real drift
                # survives the wait, delivery lag does not.
                for key, node in suspect:
                    tracked = self.cache.get_pod(key)
                    have = getattr(tracked, "node_name", None)
                    if have != node and not self.cache.is_assumed(key):
                        out.append(Violation(
                            "defrag",
                            f"post-migration pod {key} bound to {node} "
                            f"at the apiserver but cached on {have}"))
        for v in self._check_aggregates():
            out.append(Violation("defrag", "post-migration " + v.detail))
        return out

    # -- orchestration ---------------------------------------------------

    def verify_once(self) -> list[Violation]:
        """One full pass; counts, logs, and (when ``heal``) self-heals.
        Returns the violations found."""
        violations = (self._check_aggregates() +
                      self._check_device_rows() +
                      self._check_apiserver() +
                      self._check_defrag())
        self.passes += 1
        if not violations:
            return []
        self.violations_total += len(violations)
        for v in violations:
            metrics.CACHE_INVARIANT_VIOLATIONS.labels(kind=v.kind).inc()
            log.error("invariant violation %s", v)
        if self.heal:
            self._heal(violations)
        return violations

    def _heal(self, violations: list[Violation]) -> None:
        """Self-heal: force the next snapshot to rebuild everything from
        the tracked objects (epoch bump → full device re-upload), and for
        apiserver drift repair the pod set itself from truth."""
        if any(v.kind == "apiserver" for v in violations) and \
                self.truth is not None:
            try:
                self._repair_from_truth(self.truth())
            except Exception:  # noqa: BLE001 — repair is best-effort
                log.exception("apiserver repair pass failed")
        self.cache.force_resnapshot()
        if self.resident is not None:
            self.resident.invalidate()
        log.warning("self-healed %d invariant violation(s) by full "
                    "re-snapshot", len(violations))

    def _repair_from_truth(self, items: list[dict]) -> None:
        truth_bound: dict[str, dict] = {}
        for obj in items:
            key = api.key_from_json(obj)
            if (obj.get("spec") or {}).get("nodeName") and \
                    not api.is_terminated_json(obj):
                truth_bound[key] = obj
        _, confirmed, _ = self._placements_snapshot()
        for key, obj in truth_bound.items():
            node = (obj.get("spec") or {}).get("nodeName") or ""
            tracked = self.cache.get_pod(key)
            # Missing OR tracked on the wrong node: add_pod replaces the
            # stale attachment, so a lost watch event can't leave
            # capacity charged to the wrong node forever (and the same
            # violation re-firing every pass).
            if tracked is None or tracked.node_name != node:
                self.cache.add_pod(api.pod_from_json(obj))
        for key in confirmed:
            if key not in truth_bound:
                pod = self.cache.get_pod(key)
                if pod is not None:
                    self.cache.remove_pod(pod)

    def run(self, period: float = 5.0) -> threading.Thread:
        """Start the background pass every ``period`` seconds."""
        def loop():
            while not self._stop.wait(period):
                try:
                    self.verify_once()
                except Exception:  # noqa: BLE001 — verifier never kills
                    log.exception("verifier pass crashed; continuing")
        return threadreg.spawn(loop, name="cache-verifier")

    def stop(self) -> None:
        self._stop.set()
