"""Sharding of the scheduling planes over several devices (the node axis,
optionally the pod axis): ``parallel/mesh.py``."""
