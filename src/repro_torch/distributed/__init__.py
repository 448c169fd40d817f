"""Distributed substrate: the K-truss slot mesh + packed-batch sharding."""

from .ktruss import SLOT_AXIS, SlotMesh, peel_problem_specs, shard_peel_args, slot_mesh

__all__ = [
    "SLOT_AXIS",
    "SlotMesh",
    "peel_problem_specs",
    "shard_peel_args",
    "slot_mesh",
]
