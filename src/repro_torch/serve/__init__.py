"""Batched serving engines: continuous per-slot batching (``ServeEngine``)
plus the legacy wave-scheduled baseline (``WaveServeEngine``).

``Request``/``Priority`` are the public request surface — import them from
here, not from ``serve.scheduler`` internals.
"""
from .engine import BOS, EngineStats, ServeEngine, WaveServeEngine
from .scheduler import Priority, Request, SlotScheduler

__all__ = ["BOS", "EngineStats", "Priority", "Request", "ServeEngine",
           "SlotScheduler", "WaveServeEngine"]
