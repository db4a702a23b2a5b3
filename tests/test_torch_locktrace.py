"""The port's ``utils/locktrace.py`` against the JAX package's: the same
lock scenarios (inverted orders across threads, chains, re-entry, holds
past a threshold, contended acquires) give the same evidence in both.

The port records a traced lock's order edges before a blocking acquire
and its long-hold check after the release, where the reference does both
inside the critical section; these tests pin that the evidence is the
same all the same, and that the work under the lock is only the stamp."""

from __future__ import annotations

import threading
import time

import pytest

from kubernetes_tpu.utils import locktrace as jax_locktrace
from kubernetes_tpu_torch.utils import locktrace as port_locktrace

MODULES = {"jax": jax_locktrace, "port": port_locktrace}


@pytest.fixture(autouse=True)
def _clean_tracers():
    was = {k: m.enabled() for k, m in MODULES.items()}
    for m in MODULES.values():
        m.reset()
        m.set_hold_threshold_ms(100.0)
        m.set_enabled(True)
    yield
    for k, m in MODULES.items():
        m.set_enabled(was[k])
        m.reset()


def _run(fn) -> None:
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def _nest(*locks):
    def body():
        for lk in locks:
            lk.acquire()
        for lk in reversed(locks):
            lk.release()
    return body


def _inverted(lt):
    a, b = lt.make_lock("t.A"), lt.make_lock("t.B")
    _run(_nest(a, b))
    _run(_nest(b, a))


def _once_per_pair(lt):
    a, b = lt.make_lock("t.A"), lt.make_lock("t.B")
    for _ in range(3):
        _run(_nest(a, b))
        _run(_nest(b, a))


def _consistent(lt):
    a, b = lt.make_lock("t.A"), lt.make_lock("t.B")
    for _ in range(2):
        _run(_nest(a, b))


def _same_name(lt):
    _nest(lt.make_lock("t.same"), lt.make_lock("t.same"))()


def _chain(lt):
    a, b, c = (lt.make_lock(n) for n in ("t.A", "t.B", "t.C"))
    _run(_nest(a, b, c))
    _run(_nest(c, a))


def _rlock_reentry(lt):
    r, other = lt.make_rlock("t.R"), lt.make_lock("t.O")
    _nest(r, r, other)()


def _nonblocking(lt):
    lock = lt.make_lock("t.nb")
    assert lock.acquire(blocking=False)
    got = []
    _run(lambda: got.append(lock.acquire(blocking=False)))
    assert got == [False]
    lock.release()
    inner = lt.make_lock("t.in")
    assert lock.acquire(timeout=1.0)
    assert inner.acquire(blocking=False)
    inner.release()
    lock.release()


def _contended(lt):
    """Two threads queue on one lock while each holds another: the
    edges and the inversion come out as they do uncontended."""
    a, b, gate = (lt.make_lock(n) for n in ("t.A", "t.B", "t.gate"))
    start = threading.Barrier(2)

    def one(first):
        def body():
            start.wait()
            for _ in range(50):
                with first:
                    with gate:
                        pass
        return body

    ts = [threading.Thread(target=one(x)) for x in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    _run(_nest(gate, a))


SCENARIOS = {
    "inverted": _inverted, "once_per_pair": _once_per_pair,
    "consistent": _consistent, "same_name": _same_name, "chain": _chain,
    "rlock_reentry": _rlock_reentry, "nonblocking": _nonblocking,
    "contended": _contended,
}


def _evidence(lt) -> dict:
    """The report's evidence about this test's locks (named ``t.*``).
    Its counters are left out: threads that other tests left running,
    and the metrics registry's own locks, can add to them."""
    rep = lt.report()

    def ours(locks) -> bool:
        return all(n.startswith("t.") for n in locks)
    return {
        "edges": [e for e in rep["edges"] if ours(e.split(" -> "))],
        "inversions": sorted((tuple(sorted(d["locks"])), d["chain"][-1])
                             for d in rep["inversion_detail"]
                             if ours(d["locks"])),
        "long_holds": [d["lock"] for d in rep["long_hold_detail"]
                       if ours([d["lock"]])],
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_order_evidence_matches_the_reference(name):
    got = {}
    for key, lt in MODULES.items():
        SCENARIOS[name](lt)
        got[key] = _evidence(lt)
    assert got["port"] == got["jax"]
    assert got["port"]["long_holds"] == []


@pytest.mark.parametrize("rlock", [False, True])
def test_long_holds_match_the_reference(rlock):
    got = {}
    for key, lt in MODULES.items():
        lt.set_hold_threshold_ms(20.0)
        make = lt.make_rlock if rlock else lt.make_lock
        slow, off = make("t.slow"), make("t.off", hold_ms=0)
        with slow:
            if rlock:
                with slow:
                    pass
            time.sleep(0.05)
        with off:
            time.sleep(0.03)
        with make("t.fast"):
            pass
        got[key] = _evidence(lt)["long_holds"]
        held = [d["held_ms"] for d in lt.report()["long_hold_detail"]
                if d["lock"] == "t.slow"]
        assert held and held[0] >= 20.0
    assert got["port"] == got["jax"] == ["t.slow"]


def test_the_critical_section_only_stamps_the_hold(monkeypatch):
    """Inside a blocking acquire's critical section the port pushes the
    hold's start and nothing else: the order bookkeeping (which takes the
    tracer's global lock) ran before the acquire, and the long-hold check
    runs after the release."""
    lock = port_locktrace.make_lock("t.cs")
    outer = port_locktrace.make_lock("t.outer")
    seen = []
    real_acq, real_rep = (port_locktrace._record_acquiring,
                          port_locktrace._report_hold)
    monkeypatch.setattr(port_locktrace, "_record_acquiring", lambda n: (
        seen.append(("edges", n, lock.locked())), real_acq(n)))
    monkeypatch.setattr(port_locktrace, "_report_hold", lambda n, *a: (
        seen.append(("hold", n, lock.locked())), real_rep(n, *a)))
    with outer:
        with lock:
            pass
    assert ("edges", "t.cs", False) in seen
    assert ("hold", "t.cs", False) in seen
    assert _evidence(port_locktrace)["edges"] == ["t.outer -> t.cs"]
