"""Scheduler-extender HTTP server: the GPU hook for a stock control plane.

Implements the wire protocol the reference's ``HTTPExtender`` speaks
(extender.go:95-187, schema plugin/pkg/scheduler/api/v1/types.go:134-163):

    POST {urlPrefix}/{apiVersion}/{filterVerb}     ExtenderArgs -> ExtenderFilterResult
    POST {urlPrefix}/{apiVersion}/{prioritizeVerb} ExtenderArgs -> HostPriorityList

A stock kube-scheduler configured with
``examples/scheduler-policy-config-with-extender.json`` delegates its
Filter/Prioritize calls here unchanged; each request carries the pod and the
candidate node list, the engine answers from one batched device evaluation.

Also serves GET /healthz, /metrics (Prometheus text), /configz,
/debug/traces, the telemetry ring's /debug/timeseries and
/debug/dashboard, /debug/pprof and the sampling profiler's
/debug/profile — the daemon endpoints every reference binary exposes
(app/server.go:93-109; ``utils/debugmux.py``).

Counterpart of ``kubernetes_tpu/server/extender.py``: the same wire
responses, byte for byte, from PyTorch planes read back as numpy arrays
of the same dtypes.  The engines run on ``device`` (default ``cuda``).

Run: ``python -m kubernetes_tpu_torch.server.extender --port 12346
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import Policy, default_provider, policy_from_json
from kubernetes_tpu_torch.api.validation import validate_policy
from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler, Listers
from kubernetes_tpu_torch.engine.solver import batch_flags
from kubernetes_tpu_torch.features.batch import pod_template_key
from kubernetes_tpu_torch.utils import device as device_mod
from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.debugmux import common_route
from kubernetes_tpu_torch.utils.metrics import SchedulerMetrics


class _EngineEvicted(Exception):
    """Fast-path span match found but the compiled engine was LRU-evicted;
    the caller must fall back to a full parse."""


class _EvalResult:
    """One pod-template evaluation against one node list, with the filter
    verdict computed lazily and cached (the filter→prioritize pair and every
    later spec-identical pod reuse it).  Holds the shared Solver — not the
    engine — so engine-attached memos don't form reference cycles, and no
    parsed node dicts (node names suffice; responses join item_bytes)."""

    __slots__ = ("pod", "node_names", "feasible", "scores", "solver",
                 "db", "dc", "nt", "item_bytes", "_filter_parts",
                 "resp_filter", "resp_prioritize")

    def __init__(self, pod, node_names, feasible, scores, solver, db, dc,
                 nt, item_bytes):
        self.pod = pod
        self.node_names = node_names
        self.feasible = feasible
        self.scores = scores
        self.solver = solver
        self.db = db
        self.dc = dc
        self.nt = nt
        self.item_bytes = item_bytes
        self._filter_parts = None
        # Rendered wire responses, cached with the result: a 5k-node
        # HostPriorityList json.dumps costs ~6 ms and a filter item join
        # ~5 ms — on memo hits the verb becomes parse + memcpy.
        self.resp_filter: bytes | None = None
        self.resp_prioritize: bytes | None = None

    def filter_parts(self) -> tuple[np.ndarray, dict[str, str]]:
        """Feasible indices + per-node failure reasons (cached: the masks
        breakdown is a second device computation, paid once per template)."""
        if self._filter_parts is None:
            failed: dict[str, str] = {}
            masks = None
            for i in np.flatnonzero(~self.feasible):
                if masks is None:
                    masks = {k: v[0].cpu().numpy() for k, v in
                             self.solver.masks(self.db, self.dc).items()}
                reasons = [p for p, m in masks.items() if not m[i]] \
                    if self.nt.schedulable[i] else ["Unschedulable"]
                failed[self.node_names[i]] = ", ".join(reasons) or "does not fit"
            self._filter_parts = (np.flatnonzero(self.feasible), failed)
        return self._filter_parts


class ExtenderCore:
    """Per-request engine with persistent cluster state: the extender wire
    protocol carries the node list on every call (extender.go:157-187), but
    a scheduler's node list is stable between calls — so compiled node
    tensors are cached keyed on the node list's identity (names +
    resourceVersions when present, else a content digest) and only rebuilt
    when the cluster actually changed.  The Solver (jit executables) is
    shared across all cached engines.  Every engine runs on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``)."""

    _MAX_ENGINES = 4

    def __init__(self, policy: Policy | None = None,
                 device: "str | torch.device | None" = "cuda"):
        self.device = device_mod.resolve(device)
        self.policy = policy or default_provider()
        self.metrics = SchedulerMetrics()
        self._lock = threading.Lock()
        self._solver_holder: GenericScheduler | None = None
        self._engines: dict = {}   # node-list key -> GenericScheduler (LRU)
        # Evaluations are memoized per pod TEMPLATE key, nested inside the
        # engine for that node list (so memo entries die with the engine —
        # memory stays bounded by _MAX_ENGINES): the scheduler calls filter
        # then prioritize for the same pod back-to-back
        # (generic_scheduler.go:189-207, :287-305), and controller-stamped
        # replicas are spec-identical — the extender is stateless between
        # calls (the wire carries the whole node list, extender.go:157-187),
        # so identical specs against an identical node list get identical
        # verdicts.  Only genuinely new templates pay a compile + solve;
        # this is the verb-path analogue of the drain path's template dedup
        # (features/batch.py pod_template_key).
        self._TPL_MEMO_MAX = 32   # per engine
        self._inflight = 0        # concurrent handle() calls (refreeze gate)
        # Wire-path memos: the previous request's raw body with its result
        # (the prioritize call that follows filter carries byte-identical
        # ExtenderArgs, recognized by one memcmp — retaining the ~2 MB body
        # is the price of not sha256-ing it per request, ~6 ms at 5k
        # nodes), and the previous request's node-list byte span
        # (a 5k-node list is ~2 MB of JSON that rarely changes between
        # verbs — recognizing it by substring match replaces a ~60 ms parse
        # with a sub-ms memcmp).
        self._raw_memo: tuple | None = None   # (raw_body, result, item_bytes, err)
        self._span_cache: tuple | None = None  # (span_bytes, nkey, item_bytes)

    @staticmethod
    def _node_list_key(node_items: list[dict]):
        key = []
        for it in node_items:
            meta = it.get("metadata") or {}
            rv = meta.get("resourceVersion", "")
            if not rv:
                # No versions on the wire: digest the whole list.
                return hashlib.sha256(
                    json.dumps(node_items, sort_keys=True).encode()
                ).hexdigest()
            key.append((meta.get("name", ""), rv))
        return tuple(key)

    def _engine(self, node_items: list[dict] | None,
                key=None) -> GenericScheduler:
        if key is None:
            key = self._node_list_key(node_items)
        with self._lock:
            eng = self._engines.pop(key, None)
            if eng is not None:
                self._engines[key] = eng  # refresh LRU position
                return eng
        if node_items is None:
            # Fast-path caller raced an LRU eviction: it must re-parse.
            raise _EngineEvicted("node list changed")
        # Miss: parse + compile the node list once for its lifetime.
        cache = SchedulerCache()
        for it in node_items:
            cache.add_node(api.node_from_json(it))
        eng = GenericScheduler(policy=self.policy, cache=cache,
                               listers=Listers(), device=self.device)
        with self._lock:
            if self._solver_holder is not None:
                # Reuse the Solver (same policy).
                eng.solver = self._solver_holder.solver
            else:
                self._solver_holder = eng
            self._engines[key] = eng
            while len(self._engines) > self._MAX_ENGINES:
                self._engines.pop(next(iter(self._engines)))
        # A fresh engine is long-lived state (compiled node tensors for the
        # cluster's current shape): fold it into the frozen baseline so
        # gen-2 collections never scan it — an unfrozen 5k-node engine is
        # ~100k tracked objects and a single gen-2 pass over them stalls an
        # in-flight verb for tens of ms (the p99 tail).  Only when no other
        # request is in flight (their live temporaries must not be frozen);
        # the freeze runs UNDER the lock so a new request can't start
        # (handle() increments _inflight under the same lock) between the
        # quiet check and the freeze.  collect() first so only live objects
        # are frozen, and refcounting still reclaims evicted engines
        # (freeze only exempts cyclic GC).
        with self._lock:
            if self._inflight <= 1:
                _refreeze_heap()
        return eng

    def _evaluate(self, args: dict):
        # Accept both v1 lowercase keys and internal-type capitalized keys
        # (clients serialize either depending on codec).
        pod_raw = args.get("pod") or args.get("Pod") or {}
        nodes_obj = args.get("nodes") or args.get("Nodes") or {}
        node_items = nodes_obj.get("items") or nodes_obj.get("Items") or []
        return self._evaluate_parsed(pod_raw, node_items,
                                     self._node_list_key(node_items))

    def _evaluate_parsed(self, pod_raw: dict, node_items: list | None, nkey,
                         item_bytes: list | None = None) -> _EvalResult:
        pod = api.pod_from_json(pod_raw)
        tkey = pod_template_key(pod)
        eng = self._engine(node_items, nkey)
        memo = getattr(eng, "_tpl_memo", None)
        if memo is None:
            memo = eng._tpl_memo = {}
        with self._lock:
            result = memo.pop(tkey, None)
            if result is not None:
                memo[tkey] = result  # refresh LRU position
                if result.item_bytes is None:
                    result.item_bytes = item_bytes
                return result
        batch, db, dc, nt = eng._compile([pod])
        feasible, scores = eng.solver.evaluate(db, dc, batch_flags(batch))
        result = _EvalResult(pod, [n.name for n in eng.cache.nodes()],
                             feasible[0].cpu().numpy(),
                             scores[0].cpu().numpy(),
                             eng.solver, db, dc, nt, item_bytes)
        with self._lock:
            memo[tkey] = result
            while len(memo) > self._TPL_MEMO_MAX:
                memo.pop(next(iter(memo)))
        return result

    # -- wire path: parse once, recognize unchanged node lists by bytes ----

    @staticmethod
    def _scan_toplevel(raw: bytes):
        """Parse ``{"Pod": ..., "Nodes": ...}`` recording each top-level
        value's character span, so the (large, rarely-changing) node-list
        bytes can be recognized by memcmp on the next request instead of
        re-parsed.  Returns (values, spans, text)."""
        s = raw.decode("utf-8")
        dec = json.JSONDecoder()
        n = len(s)
        i = 0
        while i < n and s[i] in " \t\r\n":
            i += 1
        if i >= n or s[i] != "{":
            raise ValueError("ExtenderArgs must be a JSON object")
        i += 1
        vals: dict = {}
        spans: dict = {}
        closed = False
        while i < n:
            saw_comma = False
            while i < n and s[i] in " \t\r\n,":
                saw_comma = saw_comma or s[i] == ","
                i += 1
            if i < n and s[i] == "}":
                closed = True
                i += 1
                break
            if vals and not saw_comma:
                raise ValueError("missing ',' between members")
            if i >= n or s[i] != '"':
                raise ValueError("bad object key")
            key, i = json.decoder.scanstring(s, i + 1)
            while i < n and s[i] in " \t\r\n":
                i += 1
            if i >= n or s[i] != ":":
                raise ValueError("missing ':'")
            i += 1
            while i < n and s[i] in " \t\r\n":
                i += 1
            vals[key], j = dec.raw_decode(s, i)
            spans[key] = (i, j)
            i = j
        # Reject truncated bodies and trailing garbage the way json.loads
        # would: a short write must surface as an error, not an
        # empty-node-list verdict.
        if not closed:
            raise ValueError("unterminated ExtenderArgs object")
        if s[i:].strip():
            raise ValueError("trailing data after ExtenderArgs object")
        return vals, spans, s

    def _parse_args(self, raw: bytes, allow_fast: bool = True):
        """raw ExtenderArgs -> (pod_raw, node_items|None, nkey, item_bytes).

        Fast path: if the previous request's node-list value appears
        byte-for-byte in this body (the scheduler sends the same node list
        on every verb, extender.go:157-187), splice it out, parse only the
        small remainder (the pod), and reuse the compiled engine by key —
        the 5k parsed node dicts are deliberately NOT retained (they are
        ~100k tracked objects that turn every gen-2 GC into a multi-10 ms
        pause); only gc-untracked bytes and the key survive."""
        sp = self._span_cache
        if allow_fast and sp is not None:
            span_bytes, nkey, item_bytes = sp
            # The node list is usually the LAST member ({"Pod":..,"Nodes":..}
            # — Go marshals ExtenderArgs in struct order), so try one tail
            # memcmp (~0.2 ms on 2 MB) before the general substring search
            # (~6 ms: find() restarts a 2 MB needle at every offset).
            tail_at = len(raw) - len(span_bytes) - 1
            if tail_at >= 0 and raw.endswith(b"}") and \
                    raw[tail_at:-1] == span_bytes:
                at = tail_at
            else:
                at = raw.find(span_bytes)
            if at >= 0:
                with self._lock:
                    have_engine = nkey in self._engines
                if have_engine:
                    rest = raw[:at] + b"null" + raw[at + len(span_bytes):]
                    try:
                        args = json.loads(rest)
                    except ValueError:
                        args = None
                    if isinstance(args, dict) and any(
                            k in args and args[k] is None
                            for k in ("nodes", "Nodes")):
                        pod_raw = args.get("pod") or args.get("Pod") or {}
                        return pod_raw, None, nkey, item_bytes
        vals, spans, s = self._scan_toplevel(raw)
        pod_raw = vals.get("pod") or vals.get("Pod") or {}
        nodes_key = "nodes" if "nodes" in vals else "Nodes"
        nodes_obj = vals.get(nodes_key)
        node_items = []
        if isinstance(nodes_obj, dict):
            node_items = nodes_obj.get("items") or nodes_obj.get("Items") or []
        nkey = self._node_list_key(node_items)
        item_bytes = None
        if nodes_key in spans and node_items:
            i0, j0 = spans[nodes_key]
            item_bytes = [json.dumps(it, separators=(",", ":")).encode()
                          for it in node_items]
            self._span_cache = (s[i0:j0].encode(), nkey, item_bytes)
        return pod_raw, node_items, nkey, item_bytes

    def handle(self, verb: str, raw: bytes) -> bytes:
        """Serve one wire verb from raw request bytes to raw response bytes.
        Identical bodies (the filter→prioritize pair for one pod) hit the
        raw-body memo and cost no parsing or solving at all."""
        with self._lock:
            self._inflight += 1
        try:
            return self._handle(verb, raw)
        finally:
            with self._lock:
                self._inflight -= 1

    def _handle(self, verb: str, raw: bytes) -> bytes:
        # Recognize the filter->prioritize pair's identical body by direct
        # bytes equality (length check + memcmp, ~0.2 ms for a 2 MB body)
        # rather than hashing it (sha256 of 2 MB was ~6 ms per request).
        memo = self._raw_memo
        item_bytes = None
        result = err = None
        if memo is not None and memo[0] == raw:
            _, result, item_bytes, err = memo
        else:
            try:
                try:
                    pod_raw, node_items, nkey, item_bytes = \
                        self._parse_args(raw)
                    result = self._evaluate_parsed(pod_raw, node_items, nkey,
                                                   item_bytes)
                except _EngineEvicted:
                    # Engine evicted between span match and lookup: re-parse.
                    pod_raw, node_items, nkey, item_bytes = \
                        self._parse_args(raw, allow_fast=False)
                    result = self._evaluate_parsed(pod_raw, node_items, nkey,
                                                   item_bytes)
            except Exception as e:  # noqa: BLE001 — wire contract: Error field
                # str(e), not e: a stored exception pins its traceback
                # frames (whole call stacks of locals) until the memo is
                # replaced; only the message is part of the wire contract.
                err = str(e) or type(e).__name__
            self._raw_memo = (raw, result, item_bytes, err)
        if verb == "filter":
            if err is None:
                # Response building includes filter_parts (a device masks
                # computation): failures there must still answer the wire
                # contract's Error field, not drop the exchange.
                try:
                    if result.resp_filter is not None:
                        return result.resp_filter
                    if item_bytes is None:
                        item_bytes = result.item_bytes
                    resp = self._filter_response(result, item_bytes)
                    if item_bytes is not None:
                        # Only cache the full-echo form; a nodes-absent
                        # request renders a minimal name-only echo that
                        # must not shadow later full responses.
                        result.resp_filter = resp
                    return resp
                except Exception as e:  # noqa: BLE001 — wire contract
                    err = str(e) or type(e).__name__
            return json.dumps({"nodes": {"items": []}, "failedNodes": {},
                               "error": str(err)}).encode()
        if err is None:
            try:
                if result.resp_prioritize is None:
                    result.resp_prioritize = json.dumps(
                        self._priority_list(result)).encode()
                return result.resp_prioritize
            except Exception as e:  # noqa: BLE001 — prioritize is ignorable
                err = str(e) or type(e).__name__
        # Prioritize errors are ignorable (api/types.go:128-130): answer
        # zero scores for whatever node names can be salvaged.
        try:
            args = json.loads(raw)
            nodes_obj = (args.get("nodes") or args.get("Nodes") or {}) \
                if isinstance(args, dict) else {}
            items = (nodes_obj.get("items") or nodes_obj.get("Items")
                     or []) if isinstance(nodes_obj, dict) else []
        except ValueError:
            items = []
        return json.dumps(
            [{"host": (nd.get("metadata") or {}).get("name", ""),
              "score": 0} for nd in items]).encode()

    def _filter_response(self, result: _EvalResult, item_bytes) -> bytes:
        if item_bytes is None:
            item_bytes = result.item_bytes
        keep_idx, failed = result.filter_parts()
        if item_bytes is not None:
            # Response items join pre-serialized per-node bytes: a 5k-node
            # keep list costs a join, not a 30 ms json.dumps.
            items_blob = b",".join(item_bytes[i] for i in keep_idx)
            return (b'{"nodes":{"items":[' + items_blob + b']},"failedNodes":'
                    + json.dumps(failed).encode() + b"}")
        # No serialized items available (nodes absent/empty on the wire):
        # echo minimal objects carrying the names.
        keep = [{"metadata": {"name": result.node_names[i]}}
                for i in keep_idx]
        return json.dumps({"nodes": {"items": keep},
                           "failedNodes": failed}).encode()

    @staticmethod
    def _priority_list(result: _EvalResult) -> list[dict]:
        names, scores = result.node_names, result.scores
        smax = float(scores.max()) if len(scores) else 0.0
        out = []
        for i, name in enumerate(names):
            score = int(10.0 * scores[i] / smax) if smax > 0 else 0
            out.append({"host": name, "score": score})
        return out

    def filter(self, args: dict) -> dict:
        """ExtenderArgs -> ExtenderFilterResult (extender.go:97-125)."""
        try:
            result = self._evaluate(args)
            keep_idx, failed = result.filter_parts()
            # Echo this request's node objects (a memo hit may carry
            # node_items=None from the wire fast path).
            nodes_obj = args.get("nodes") or args.get("Nodes") or {}
            node_items = nodes_obj.get("items") or nodes_obj.get("Items") or []
            return {"nodes": {"items": [node_items[i] for i in keep_idx]},
                    "failedNodes": failed}
        except Exception as err:  # noqa: BLE001 — wire contract: Error field
            return {"nodes": {"items": []}, "failedNodes": {},
                    "error": str(err)}

    def prioritize(self, args: dict) -> list[dict]:
        """ExtenderArgs -> HostPriorityList (extender.go:130-154).  Combined
        weighted scores are rescaled to the extender's 0-10 band."""
        try:
            return self._priority_list(self._evaluate(args))
        except Exception:  # noqa: BLE001 — prioritize errors are ignorable
            nodes_obj = args.get("nodes") or args.get("Nodes") or {}
            items = nodes_obj.get("items") or nodes_obj.get("Items") or []
            return [{"host": (nd.get("metadata") or {}).get("name", ""),
                     "score": 0} for nd in items]


def make_handler(core: ExtenderCore):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/configz":
                cfg = {"predicates": [p.name for p in core.policy.predicates],
                       "priorities": [(s.name, s.weight)
                                      for s in core.policy.priorities]}
                self._send(200, json.dumps(cfg).encode())
                return
            # healthz / metrics / debug tree: the shared daemon routes.
            resolved = common_route(
                path, metrics_fn=core.metrics.expose, query=query,
                openmetrics_fn=core.metrics.expose_openmetrics)
            if resolved is None:
                self._send(404, b"not found", "text/plain")
            else:
                code, body, ctype = resolved
                self._send(code, body, ctype)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) or b"{}"
            # Dispatch on the trailing verb; the prefix/apiVersion segments
            # are caller-configured (extender.go:166 builds
            # urlPrefix/apiVersion/verb).
            verb = self.path.rstrip("/").rsplit("/", 1)[-1]
            if verb not in ("filter", "prioritize"):
                self._send(404, b'{"error": "unknown verb"}')
                return
            start = time.perf_counter()
            body = core.handle(verb, raw)
            dur = time.perf_counter() - start
            core.metrics.scheduling_algorithm_latency.observe(dur * 1e6)
            # The verb span joins the calling scheduler's trace when it
            # propagated a traceparent header.
            trace.record_server_span(
                "extender." + verb,
                self.headers.get("traceparent", ""), dur)
            self._send(200, body)

    return Handler


def serve(port: int = 12346, policy: Policy | None = None,
          host: str = "127.0.0.1",
          device: "str | torch.device | None" = "cuda"
          ) -> ThreadingHTTPServer:
    core = ExtenderCore(policy, device=device)
    # Self-scrape ring behind /debug/timeseries + /debug/dashboard: the
    # extender's verb-latency metric set rides next to the registry.
    from kubernetes_tpu_torch.utils import profiler, telemetry
    telemetry.ensure_started(core.metrics.all_metrics())
    # kt-prof sampling starts with the daemon (no-op when KT_PROF=0).
    profiler.ensure_started()
    server = ThreadingHTTPServer((host, port), make_handler(core))
    _freeze_baseline_heap()
    return server


_heap_frozen = False


def _freeze_baseline_heap() -> None:
    # The post-import heap (torch + friends) is a few hundred thousand
    # long-lived objects; every gen-2 collection scans them all and stalls
    # an in-flight verb for tens of ms.  Freeze the stable heap so cyclic
    # GC only ever walks objects created while serving.  Once per process
    # at startup; _refreeze_heap extends the baseline after cold compiles.
    global _heap_frozen
    if _heap_frozen:
        return
    _heap_frozen = True
    gc.collect()
    gc.freeze()


def _refreeze_heap() -> None:
    """Fold objects that survived a cold compile into the frozen baseline.
    collect() first so only *live* objects freeze; cyclic garbage created
    since the last freeze is reclaimed, not immortalized.  Refcounting
    still frees frozen objects when dropped — freeze only exempts them
    from gen-2 scans, which is exactly what keeps verb tails flat."""
    gc.collect()
    gc.freeze()


def serve_in_thread(port: int = 0, policy: Policy | None = None,
                    host: str = "127.0.0.1",
                    device: "str | torch.device | None" = "cuda"
                    ) -> ThreadingHTTPServer:
    server = serve(port, policy, host, device)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="extender-http").start()
    return server


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=12346)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--policy-config-file", default="",
                    help="scheduler policy JSON (CreateFromConfig analogue)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (cuda or cpu)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    opts = parse_args(argv)
    policy = None
    if opts.policy_config_file:
        with open(opts.policy_config_file) as f:
            policy = policy_from_json(f.read())
        validate_policy(policy)
    server = serve(opts.port, policy, opts.host, opts.device)
    print(f"gpu-scheduler extender listening on {opts.host}:{opts.port} "
          f"(device {opts.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
