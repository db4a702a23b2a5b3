"""Fault injection: ``chaos.device`` makes the card misbehave on a
deterministic cadence for the device guard (engine/guard.py)."""

from kubernetes_tpu_torch.chaos.device import (DeviceChaos, DeviceRule,
                                               SimulatedDeviceError)

__all__ = ["DeviceChaos", "DeviceRule", "SimulatedDeviceError"]
