"""HTTP scheduler-extender client (the reference's HTTPExtender,
extender.go:39-187): this engine can also *call out* to extenders configured
in the policy, exactly as the stock scheduler does — filter after built-in
predicates, prioritize added at the configured weight.

Timeout semantics (api/types.go:128-130): a filter timeout fails the pod's
scheduling; a prioritize timeout is ignored (zero scores).

Hardening beyond the reference: filter/prioritize exchanges are read-only
queries, so transport faults get one bounded retry; consecutive failures
trip a circuit breaker (``utils.circuitbreaker``).  While the breaker is
open, ``filter`` raises ``ExtenderUnavailable`` — the engine treats that as
"skip this extender" (built-in-predicates-only degradation) instead of the
per-pod scheduling failure a closed-breaker timeout still causes.  A dead
extender therefore fails at most ``BREAKER_THRESHOLD`` pods per breaker
window instead of every pod forever."""

from __future__ import annotations

import http.client
import json
import random
import socket
import time
import urllib.error
import urllib.request
import weakref

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import ExtenderConfig
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.circuitbreaker import OPEN, CircuitBreaker
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("extender")

# Faults where the exchange did not complete (connection refused, timeout,
# garbled/truncated response): retriable, counted on the breaker.  Note
# http.client.HTTPException (BadStatusLine, IncompleteRead) is NOT an
# OSError — omitting it would let a half-open trial escape without
# recording, wedging the breaker in half-open forever.
TRANSPORT_ERRORS = (urllib.error.URLError, http.client.HTTPException,
                    socket.timeout, OSError)

# Bounded retry of one extender exchange: the calls are idempotent reads,
# but the pod's scheduling latency is on the line — one quick retry, no
# more (the breaker handles persistent death).
EXTENDER_MAX_RETRIES = 1
EXTENDER_RETRY_SLEEP = 0.05

# Breaker: N consecutive transport failures open it for T seconds.
BREAKER_THRESHOLD = 3
BREAKER_RESET_S = 15.0


class ExtenderError(Exception):
    pass


class ExtenderUnavailable(ExtenderError):
    """The extender's circuit breaker is open: the endpoint is known-dead
    and was not called.  The engine degrades to built-in predicates for
    this extender rather than failing the pod."""


# The open-breaker gauge reads live object state, not paired inc/dec: an
# HTTPExtender discarded while its breaker is open (scheduler rebuilt
# with a new policy) silently leaves the set when it is collected, so the
# gauge can never stick at >=1 with zero breakers actually open.
_OPEN_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()
metrics.EXTENDER_BREAKER_OPEN.set_fn(lambda: len(_OPEN_BREAKERS))


class HTTPExtender:
    def __init__(self, config: ExtenderConfig,
                 breaker: CircuitBreaker | None = None):
        self.config = config
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=BREAKER_THRESHOLD,
            reset_timeout=BREAKER_RESET_S,
            on_transition=self._on_breaker_transition)

    def _on_breaker_transition(self, old: str, new: str) -> None:
        metrics.EXTENDER_BREAKER_TRANSITIONS.labels(state=new).inc()
        # One line per state change (not per pod: the scheduler degrades
        # thousands of pods per open window — see generic_scheduler.py).
        log.warning("extender %s breaker %s -> %s",
                    self.config.url_prefix, old, new)
        if new == OPEN:
            _OPEN_BREAKERS.add(self.breaker)
        elif old == OPEN:
            _OPEN_BREAKERS.discard(self.breaker)

    def _send(self, verb: str, args: dict):
        url = (f"{self.config.url_prefix.rstrip('/')}/"
               f"{self.config.api_version}/{verb}")
        headers = {"Content-Type": "application/json"}
        tp = trace.traceparent()
        if tp:
            headers["traceparent"] = tp
        req = urllib.request.Request(
            url, data=json.dumps(args).encode(),
            headers=headers, method="POST")
        with urllib.request.urlopen(
                req, timeout=self.config.http_timeout_s) as resp:
            return json.loads(resp.read())

    def _send_with_retry(self, verb: str, args: dict):
        """One bounded retry on transport faults; records the outcome on
        the breaker.  Wire-contract errors (the server answered) count as
        successes for the breaker — the endpoint is alive."""
        attempt = 0
        while True:
            try:
                result = self._send(verb, args)
            except (urllib.error.HTTPError, ValueError):
                # The server ANSWERED (an HTTP error status, or a 200
                # with malformed JSON): the endpoint is alive, so the
                # breaker records a success, and a retry would only
                # repeat the same answer.  The caller still applies the
                # per-call semantics (filter error fails this pod).
                self.breaker.record_success()
                raise
            except TRANSPORT_ERRORS:
                if attempt < EXTENDER_MAX_RETRIES:
                    metrics.EXTENDER_RETRIES.labels(verb=verb).inc()
                    attempt += 1
                    time.sleep(EXTENDER_RETRY_SLEEP *
                               (0.5 + random.random()))
                    continue
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            return result

    def _args(self, pod: api.Pod, nodes: list[api.Node]) -> dict:
        return {"pod": api.pod_to_json(pod),
                "nodes": {"items": [api.node_to_json(n) for n in nodes]}}

    def filter(self, pod: api.Pod, nodes: list[api.Node]
               ) -> tuple[list[api.Node], dict[str, str]]:
        """Subset + FailedNodesMap; raises ExtenderError on error/timeout
        (extender.go:97-125), ExtenderUnavailable while the breaker is
        open (the caller degrades instead of failing the pod)."""
        if not self.config.filter_verb:
            return nodes, {}
        if not self.breaker.allow():
            raise ExtenderUnavailable(
                f"extender {self.config.url_prefix} circuit open")
        try:
            result = self._send_with_retry(self.config.filter_verb,
                                           self._args(pod, nodes))
        except TRANSPORT_ERRORS + (ValueError,) as err:
            raise ExtenderError(f"extender filter failed: {err}") from err
        if result.get("error"):
            raise ExtenderError(result["error"])
        keep_names = {(n.get("metadata") or {}).get("name", "")
                      for n in (result.get("nodes") or {}).get("items") or []}
        kept = [n for n in nodes if n.name in keep_names]
        return kept, dict(result.get("failedNodes") or {})

    def prioritize(self, pod: api.Pod, nodes: list[api.Node]
                   ) -> dict[str, float]:
        """Weighted score per host; errors/timeouts yield zeros
        (generic_scheduler.go:287-305 ignores prioritize failures), as
        does an open breaker (no call is made)."""
        if not self.config.prioritize_verb:
            return {}
        if not self.breaker.allow():
            return {}
        try:
            result = self._send_with_retry(self.config.prioritize_verb,
                                           self._args(pod, nodes))
        except TRANSPORT_ERRORS + (ValueError,):
            return {}
        out: dict[str, float] = {}
        for entry in result or []:
            host = entry.get("host", "")
            if host:
                out[host] = float(entry.get("score", 0)) * self.config.weight
        return out
