"""GenericScheduler end to end, both packages on the same synthetic rig:
the port (kubernetes_tpu_torch, on the CPU) against the JAX package.

Tolerance: exact equality of every placement, the round-robin counter
and the device-aggregate handoff (final requested/nonzero), for
``schedule_batch`` and ``schedule_batch_stream(chunk_size=64)``, on a
roomy ``mixed``/``rich`` rig, on a contended rig where pods run out of
room, and for a second drain after the first is assumed (the dirty-row
scatter path of the resident cluster)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler

from torch_parity import ref_rig, torch_rig

RIGS = {
    "mixed": ("mixed", 64, 300),
    "rich": ("rich", 64, 300),
    "contended": ("mixed", 10, 300),
}


def _pair(name: str):
    profile, n_nodes, n_pods = RIGS[name]
    r_eng, r_pods, placements = ref_rig(profile, n_nodes, n_pods,
                                        n_existing=40)
    t_eng, t_pods = torch_rig(profile, n_nodes, n_pods, placements)
    return r_eng, r_pods, t_eng, t_pods


def _stream(eng, pods, chunk: int = 64) -> list:
    return [node for _, placed in eng.schedule_batch_stream(
        pods, chunk_size=chunk) for node in placed]


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_schedule_batch_matches_reference(rig):
    r_eng, r_pods, t_eng, t_pods = _pair(rig)
    want = r_eng.schedule_batch(r_pods)
    got = t_eng.schedule_batch(t_pods)
    assert got == want
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)
    hr, ht = r_eng.take_agg_handoff(), t_eng.take_agg_handoff()
    assert (hr is None) == (ht is None)
    if hr is not None:
        assert hr[1] == ht[1]
        assert np.array_equal(np.asarray(hr[3]), ht[3])
        assert np.array_equal(np.asarray(hr[4]), ht[4])
        assert ht[3].dtype == np.int32
    if rig == "contended":
        assert None in got and any(got)


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_schedule_batch_stream_matches_reference(rig):
    r_eng, r_pods, t_eng, t_pods = _pair(rig)
    want = _stream(r_eng, r_pods)
    got = _stream(t_eng, t_pods)
    assert got == want
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)


def test_deferred_readback_yields_the_same_placements():
    _, _, t_eng, t_pods = _pair("mixed")
    _, _, t_eng2, t_pods2 = _pair("mixed")
    direct = _stream(t_eng, t_pods)
    deferred = [node for _, resolve in t_eng2.schedule_batch_stream(
        t_pods2, chunk_size=64, defer_readback=True)
        for node in resolve()[1]]
    assert deferred == direct


def test_second_drain_after_assume_takes_the_scatter_path():
    """Drain 10 pods, assume them through the aggregate handoff, then
    stream the rest: the port's resident cluster patches the dirty rows
    instead of re-uploading, and still matches the reference."""
    r_eng, r_pods, t_eng, t_pods = _pair("mixed")
    for eng, pods in ((r_eng, r_pods), (t_eng, t_pods)):
        first = eng.schedule_batch(pods[:10])
        eng.cache.assume_pods([(p, n) for p, n in zip(pods[:10], first)
                               if n is not None],
                              agg_handoff=eng.take_agg_handoff())
    full_before = t_eng.resident.stats["full_syncs"]
    want = _stream(r_eng, r_pods[10:])
    got = _stream(t_eng, t_pods[10:])
    assert got == want
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)
    assert t_eng.resident.stats["row_syncs"] == 1
    assert t_eng.resident.stats["full_syncs"] == full_before


def test_empty_inputs():
    eng = GenericScheduler(device="cpu")
    pod = tapi.Pod(name="p", namespace="default")
    assert eng.schedule_batch([]) == []
    assert eng.schedule_batch([pod]) == [None]
    assert list(eng.schedule_batch_stream([pod], chunk_size=4)) == \
        [([pod], [None])]


def test_paths_of_later_slices_raise_not_implemented():
    _, _, t_eng, t_pods = _pair("mixed")
    pod = t_pods[0]
    with pytest.raises(NotImplementedError, match="joint"):
        t_eng.schedule_batch([pod], joint=True)
    # Preemption has landed (tests/test_torch_preemption.py): a pod
    # without priority never preempts, and the victim table is built.
    assert t_eng.find_preemptions([pod]) == []
    vt = t_eng.cache.victim_table(4)
    assert vt.req.shape == (len(t_eng.cache.nodes()), 4, 4)
    spread = tapi.Pod(name="s", namespace="default", annotations={
        tapi.TOPOLOGY_SPREAD_ANNOTATION_KEY: json.dumps([{
            "maxSkew": 1, "topologyKey": tapi.ZONE_LABEL,
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "x"}}}])})
    with pytest.raises(NotImplementedError, match="topology"):
        t_eng.schedule_batch([spread])
    with pytest.raises(NotImplementedError, match="topology"):
        t_eng.schedule(spread)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenericScheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenericScheduler(device="cuda")
