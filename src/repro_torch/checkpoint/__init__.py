"""Sharded, async, elastically-reshardable checkpoints."""
from .manager import CheckpointManager
