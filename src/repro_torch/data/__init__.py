"""Deterministic synthetic data pipeline (sharded, packed, prefetched)."""
from .pipeline import Batch, DataConfig, PrefetchLoader, SyntheticDataset, EOS
