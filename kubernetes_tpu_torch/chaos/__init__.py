"""Fault injection for the control plane and the card.

``chaos.proxy.ChaosProxy`` is an in-process HTTP proxy that sits between
any daemon and the apiserver and injects faults per rule: 5xx bursts, 409
storms, connection resets, response latency, watch-stream mid-event cuts,
and forced 410 Gone.  Rules are configurable programmatically and over a
``/chaos/rules`` admin endpoint so multiprocess e2e rigs can drive it.
``chaos.device`` makes the card misbehave on a deterministic cadence for
the device guard (engine/guard.py); ``chaos.bindmonitor.BindMonitor``
referees binds on a store's pod stream.
"""

from kubernetes_tpu_torch.chaos.bindmonitor import BindMonitor
from kubernetes_tpu_torch.chaos.device import (DeviceChaos, DeviceRule,
                                               SimulatedDeviceError)
from kubernetes_tpu_torch.chaos.proxy import (FAULT_CUT_STREAM, FAULT_ERROR,
                                              FAULT_LATENCY, FAULT_RESET,
                                              ChaosProxy, Rule,
                                              bind_conflict_storm,
                                              heartbeat_drop, node_flap,
                                              overload,
                                              watch_cut_on_relist)

__all__ = ["ChaosProxy", "Rule", "FAULT_ERROR", "FAULT_RESET",
           "FAULT_LATENCY", "FAULT_CUT_STREAM", "heartbeat_drop",
           "node_flap", "watch_cut_on_relist", "bind_conflict_storm",
           "overload", "DeviceChaos", "DeviceRule",
           "SimulatedDeviceError", "BindMonitor"]
