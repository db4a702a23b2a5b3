"""Gang scheduling: all-or-nothing admission for co-scheduled pod groups.

A gang is the set of pending pods sharing a ``scheduling.kt.io/gang``
annotation value (api/types.py).  TPU multi-slice jobs are the motivating
shape: a 4-slice training job that gets 3 of its 4 workers bound makes no
progress while holding capacity hostage — the reference points for the
semantics are Borg's job-level admission (Verma et al., EuroSys 2015 §2.2)
and the kube coscheduling plugin's minMember contract.

The guarantee is enforced at ADMISSION: after the batched solve produces
the assignment vector, ``reduce_all_or_nothing`` nulls the placements of
every gang whose placed member count is below its required size, so the
daemon never assumes or binds a partial gang.  Rejected members requeue
with backoff; the queue's gang hold (scheduler/queue.py) re-releases them
only as a complete unit, so the next drain solves the whole gang again.

Bind-time faults (chaos 409/reset) are repaired per member: the already-
bound members keep their nodes, the failed member requeues and — because
its siblings' capacity is already committed — rebinding converges to the
full gang.  The all-or-nothing invariant is therefore an admission-time
guarantee plus convergence under faults, pinned by the chaos e2e suite
(tests/test_chaos_control_plane.py) and the property tests
(tests/test_workload_constraints.py).
"""

from __future__ import annotations

from typing import Optional, Sequence


def gang_groups(pods: Sequence) -> dict[str, list[int]]:
    """Batch indices of each gang present in ``pods`` (annotation-keyed)."""
    groups: dict[str, list[int]] = {}
    for i, pod in enumerate(pods):
        name = pod.gang
        if name:
            groups.setdefault(name, []).append(i)
    return groups


def required_size(pods: Sequence, members: list[int]) -> int:
    """The gang's all-or-nothing floor: the largest declared
    ``gang-size`` among members, never below the member count present
    (an undeclared size means "whoever drained together")."""
    declared = max((pods[i].gang_size for i in members), default=0)
    return max(declared, len(members))


def reduce_all_or_nothing(pods: Sequence, placements: list
                          ) -> tuple[list, dict[str, dict]]:
    """The post-solve gang-feasibility reduction over the assignment
    vector: a gang is admitted only if EVERY member placed AND at least
    its declared size of members are present in this batch; otherwise
    every member's placement is nulled (the capacity its members consumed
    during the scan is released when the daemon skips their assume).

    Returns (reduced placements, rejections) where rejections maps gang
    name -> {"required", "present", "placed", "members": [batch idx]}.
    """
    groups = gang_groups(pods)
    if not groups:
        return placements, {}
    out = list(placements)
    rejected: dict[str, dict] = {}
    for name, members in groups.items():
        need = required_size(pods, members)
        placed = [i for i in members if out[i] is not None]
        if len(members) >= need and len(placed) == len(members):
            continue
        for i in members:
            out[i] = None
        rejected[name] = {"required": need, "present": len(members),
                          "placed": len(placed), "members": members}
    return out, rejected


def partial_gangs(bound_by_gang: dict[str, tuple[int, int]]
                  ) -> list[str]:
    """Names of gangs with SOME but not all members bound — the invariant
    probe the chaos suite asserts empty at settle.  Input maps gang name
    -> (bound members, gang size)."""
    return [name for name, (bound, size) in bound_by_gang.items()
            if 0 < bound < size]


def gang_failure_message(name: str, info: dict) -> str:
    if info["present"] < info["required"]:
        return (f"gang {name!r}: only {info['present']}/{info['required']} "
                f"members present in the batch; rejecting atomically")
    return (f"gang {name!r}: only {info['placed']}/{info['required']} "
            f"members fit; rejecting atomically (all-or-nothing)")


def batch_has_gangs(pods: Sequence) -> bool:
    return any(pod.gang for pod in pods)
