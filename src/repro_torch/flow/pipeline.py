"""Composable stage pipeline with artifact-prefix caching.

A :class:`Pipeline` is an ordered chain of :class:`~repro_torch.flow.stages.Stage`
objects.  ``run(config)`` threads an :class:`~repro_torch.flow.artifacts.Artifacts`
value through the chain; with an :class:`~repro_torch.flow.artifacts.ArtifactStore`
attached, every stage's output delta is cached under ``(stage name,
fingerprint of all config fields any stage so far depends on)`` — so two
configs that differ only in a *later* stage's fields (say, the clustering
algorithm) share the expensive timing prefix instead of recomputing it.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .artifacts import Artifacts, ArtifactStore
from .config import FlowConfig
from .stages import Stage, default_stages


def _content_digest(value: Any) -> Any:
    """Hashable, value-exact digest of a stage input artifact.

    Arrays key on their raw bytes (exact — no hash collisions to reason
    about; the flow's cacheable inputs are small slack/label vectors).
    Returns ``None`` for values that cannot be digested, which disables
    content keying for that stage run.
    """
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (int, float, str, bool, bytes, type(None))):
        return (type(value).__name__, value)
    return None


class Pipeline:
    """An ordered, editable chain of flow stages.

    ``content_cache`` (default on) lets stages that declare
    ``content_cache = True`` key their cached output on the *values* of their
    required artifacts instead of the accumulated upstream config
    fingerprint.  The cluster stage is the motivating case: min-slack vectors
    are identical across technology nodes (the synthesized timing structure
    is tech-independent), so one clustering per algorithm serves every tech
    of a sweep.  Pass ``content_cache=False`` to reproduce the purely
    prefix-keyed behaviour (the perf baseline of the ``flow`` benchmark).
    """

    def __init__(self, stages: Optional[Sequence[Stage]] = None, *,
                 content_cache: bool = True):
        self.stages: List[Stage] = list(default_stages() if stages is None
                                        else stages)
        self.content_cache = content_cache
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")

    # -- composition ---------------------------------------------------------

    def _index(self, name: str) -> int:
        for i, s in enumerate(self.stages):
            if s.name == name:
                return i
        raise KeyError(f"no stage named {name!r}; have "
                       f"{[s.name for s in self.stages]}")

    def replace(self, name: str, stage: Stage) -> "Pipeline":
        """New pipeline with the named stage swapped for ``stage``."""
        out = list(self.stages)
        out[self._index(name)] = stage
        return Pipeline(out, content_cache=self.content_cache)

    def without(self, *names: str) -> "Pipeline":
        """New pipeline with the named stage(s) removed (skipped)."""
        drop = set(names)
        for n in drop:
            self._index(n)                      # raise on unknown names
        return Pipeline([s for s in self.stages if s.name not in drop],
                        content_cache=self.content_cache)

    def insert_after(self, name: str, stage: Stage) -> "Pipeline":
        out = list(self.stages)
        out.insert(self._index(name) + 1, stage)
        return Pipeline(out, content_cache=self.content_cache)

    def insert_before(self, name: str, stage: Stage) -> "Pipeline":
        out = list(self.stages)
        out.insert(self._index(name), stage)
        return Pipeline(out, content_cache=self.content_cache)

    def __repr__(self) -> str:
        return f"Pipeline({[s.name for s in self.stages]})"

    # -- validation ----------------------------------------------------------

    def check(self, initial: Iterable[str] = ()) -> None:
        """Verify every stage's ``requires`` is satisfied by earlier stages
        (or by artifacts provided up front).  Raises ``ValueError`` early
        instead of failing mid-run."""
        have = set(initial)
        for s in self.stages:
            missing = set(s.requires) - have
            if missing:
                raise ValueError(
                    f"stage {s.name!r} requires {sorted(missing)} but only "
                    f"{sorted(have)} are available; reorder or provide them")
            have |= set(s.provides)

    # -- execution -----------------------------------------------------------

    def run(self, cfg: Optional[FlowConfig] = None, *,
            store: Optional[ArtifactStore] = None,
            initial: Optional[Artifacts] = None,
            upto: Optional[str] = None) -> Artifacts:
        """Execute the chain on ``cfg`` and return the final artifacts.

        ``store``   — cross-run cache; unchanged stage prefixes short-circuit.
                      A cached entry is only reused when the *whole upstream
                      stage chain* (implementations + relevant config fields)
                      matches; replacing or inserting a stage invalidates it
                      and everything downstream.
        ``initial`` — artifacts provided up front (stages may consume them).
                      Non-empty initial artifacts disable the store for this
                      run: their contents are not part of the cache key, so
                      reusing cached outputs would be unsound.
        ``upto``    — stop after the named stage (inclusive), e.g. run just
                      the timing+clustering prefix.
        """
        cfg = FlowConfig() if cfg is None else cfg
        art = Artifacts() if initial is None else initial
        self.check(initial=art.keys())

        stop = len(self.stages) if upto is None else self._index(upto) + 1
        use_store = (store is not None and hasattr(cfg, "fingerprint")
                     and len(art) == 0)
        upstream_keys: Tuple[str, ...] = ()
        chain: Tuple[str, ...] = ()
        for stage in self.stages[:stop]:
            upstream_keys = tuple(dict.fromkeys(upstream_keys
                                                + tuple(stage.config_keys)))
            chain = chain + (stage.cache_token(),)
            if use_store:
                key = self._store_key(stage, art, cfg, chain, upstream_keys)
                delta = store.get(key)
                if delta is None:
                    new = stage.run(art, cfg)
                    delta = new.delta_from(art)
                    store.put(key, delta)
                art = art.merged(delta)
            else:
                art = stage.run(art, cfg)
        return art

    def _store_key(self, stage: Stage, art: Artifacts, cfg: FlowConfig,
                   chain: Tuple[str, ...], upstream_keys: Tuple[str, ...]):
        """Cache key for one stage execution.

        Default: prefix keying — the upstream implementation chain plus the
        fingerprint of every config field any stage so far depends on.
        Content keying (stage.content_cache, pipeline content_cache on, and
        all required artifacts digestible): the stage's own implementation +
        config fields + the exact *values* of its inputs, so runs reaching
        identical inputs through different upstream configs share work.
        """
        if self.content_cache and getattr(stage, "content_cache", False):
            digests = tuple(_content_digest(art[r]) for r in stage.requires
                            if r in art)
            if len(digests) == len(stage.requires) and \
                    all(d is not None for d in digests):
                return (stage.name,
                        ("content", stage.cache_token(),
                         cfg.fingerprint(tuple(stage.config_keys)),
                         tuple(zip(stage.requires, digests))))
        return (stage.name, (chain, cfg.fingerprint(upstream_keys)))


def execute(cfg: Optional[FlowConfig] = None, *,
            pipeline: Optional[Pipeline] = None,
            store: Optional[ArtifactStore] = None) -> Artifacts:
    """One-call convenience: run ``cfg`` through ``pipeline`` (default: the
    canonical Fig. 9 chain) and return every artifact."""
    return (pipeline or Pipeline()).run(cfg, store=store)
