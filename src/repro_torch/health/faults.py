"""Replica failures the serving engine understands. The fault-injection
harness (fault plans, corrupted checkpoints and indexes) comes with the
health slice."""
from __future__ import annotations

__all__ = ["ReplicaFailure"]


class ReplicaFailure(RuntimeError):
    """A serving replica failed a dispatch. The ONLY exception class the
    serving engine converts into an abandoned batch (`DrainResult`
    .abandoned) instead of propagating — anything else is a bug and must
    surface. Raise it (or a subclass) from a route to model a replica
    that cannot answer."""
