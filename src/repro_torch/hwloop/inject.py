"""Pluggable silent-corruption models for the emulated accelerator.

When a MAC's effective arrival time falls past the Razor shadow window
(``SILENT`` in :mod:`repro_torch.core.razor`), the error is *invisible* to the
runtime scheme and some corrupted value reaches the output.  What that value
is depends on the microarchitecture; the literature models it three ways:

* ``"stale"``   — the paper's (and
  :class:`repro_torch.core.systolic.SystolicSim`'s)
  semantics: the MAC's output register re-emits its previous-cycle partial
  sum, so silent rows inherit the psum of the last clean row above them
  (a per-column forward fill).
* ``"tedrop"``  — ThUnderVolt's TE-Drop (Zhang et al., 2018): the failing
  MAC's multiply is dropped and the partial sum bypasses it unchanged —
  equivalent to zeroing the failing rank-1 term.
* ``"bitflip"`` — a single mantissa bit of the affected accumulator output is
  flipped (classic SEU-style corruption used in undervolting studies such as
  Salami et al., 2020).

Every model is a pure function ``(terms, silent, rng) -> out`` where
``terms`` is the ``(M, K, N)`` rank-1 term tensor of one weight tile
(``terms[m, i, j] = a[m, i] * w[i, j]``), ``silent`` is the matching boolean
failure mask, and ``out`` is the ``(M, N)`` corrupted tile product.  Models
are registered by name so :class:`repro_torch.flow.FlowConfig` can select
them declaratively (``hwloop_corruption``).

The numpy models are the port's copy of ``repro.hwloop.inject``, bit for
bit; the accelerator runs them on CPU operands.  Each also has a *tile
form* in torch, registered beside it (``register_corruption(name,
tiles=...)``), which the tiled form of :mod:`repro_torch.hwloop.tiled` runs
on the operands' device: ``(terms, silent, gen) -> out`` over a leading
batch of tiles, ``terms`` and ``silent`` (T, M, K, N), ``out`` (T, M, N),
float64.  All three models act on each output column alone, so N may hold
any number of side-by-side tiles.  The tile forms make no host
synchronisation; a model without one cannot run on a GPU
(:func:`get_tile_corruption` raises).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

CorruptionFn = Callable[[np.ndarray, np.ndarray, np.random.Generator],
                        np.ndarray]
TileCorruptionFn = Callable[[torch.Tensor, torch.Tensor,
                             Optional[torch.Generator]], torch.Tensor]

CORRUPTION_MODELS: Dict[str, CorruptionFn] = {}
#: the torch tile forms, by the same names
TILE_MODELS: Dict[str, TileCorruptionFn] = {}


def register_corruption(name: str, *,
                        tiles: Optional[TileCorruptionFn] = None):
    """Decorator: make a corruption model selectable by name.  ``tiles`` is
    its torch tile form, which the accelerator needs on a GPU."""

    def deco(fn: CorruptionFn) -> CorruptionFn:
        CORRUPTION_MODELS[name] = fn
        if tiles is not None:
            TILE_MODELS[name] = tiles
        return fn

    return deco


def get_corruption(name: str) -> CorruptionFn:
    try:
        return CORRUPTION_MODELS[name]
    except KeyError:
        raise KeyError(f"unknown corruption model {name!r}; registered: "
                       f"{sorted(CORRUPTION_MODELS)}") from None


def get_tile_corruption(name: str) -> TileCorruptionFn:
    """The torch tile form of the model ``name``."""
    get_corruption(name)                          # unknown names say so
    try:
        return TILE_MODELS[name]
    except KeyError:
        raise KeyError(f"corruption model {name!r} has no torch tile form "
                       f"(register_corruption(..., tiles=)); it cannot run "
                       f"on a GPU") from None


# ---------------------------------------------------------------------------
# Tile forms (torch; a leading batch of tiles, float64, on any device)
# ---------------------------------------------------------------------------


def _sum_terms(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the K axis (dim 2) term by term, in order."""
    out = terms[:, :, 0, :].clone()
    for i in range(1, terms.shape[2]):
        out = out + terms[:, :, i, :]
    return out


def stale_psum_tiles(terms: torch.Tensor, silent: torch.Tensor,
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`stale_psum` over a batch of tiles: the forward fill along M
    from the last clean row (``torch.cummax`` over the last-clean row
    index), at every K step (a step with nothing silent leaves ``out`` as
    it is)."""
    t, m_rows, k, n_cols = terms.shape
    row_ix = torch.arange(m_rows, device=terms.device).view(1, m_rows, 1)
    minus_one = torch.full((), -1, dtype=torch.int64, device=terms.device)
    zero = torch.zeros((), dtype=terms.dtype, device=terms.device)
    out = torch.zeros((t, m_rows, n_cols), dtype=terms.dtype,
                      device=terms.device)
    for i in range(k):
        out = out + terms[:, :, i, :]
        sil = silent[:, :, i, :]
        last = torch.cummax(torch.where(sil, minus_one, row_ix), dim=1).values
        filled = torch.gather(out, 1, last.clamp(min=0))
        out = torch.where(sil, torch.where(last >= 0, filled, zero), out)
    return out


def te_drop_tiles(terms: torch.Tensor, silent: torch.Tensor,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`te_drop` over a batch of tiles."""
    return _sum_terms(torch.where(silent, torch.zeros((), dtype=terms.dtype,
                                                      device=terms.device),
                                  terms))


def bit_flip_tiles(terms: torch.Tensor, silent: torch.Tensor,
                   gen: Optional[torch.Generator] = None, *,
                   bit: int = 40) -> torch.Tensor:
    """:func:`bit_flip` over a batch of tiles: the float64 sums viewed as
    int64, bit ``bit`` XORed where the column saw a silent failure."""
    out = _sum_terms(terms).contiguous()
    hit = silent.any(dim=2)
    flip = torch.where(hit, torch.full((), 1 << bit, dtype=torch.int64,
                                       device=terms.device),
                       torch.zeros((), dtype=torch.int64,
                                   device=terms.device))
    return (out.view(torch.int64) ^ flip).view(torch.float64)


@register_corruption("stale", tiles=stale_psum_tiles)
def stale_psum(terms: np.ndarray, silent: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    """Stale-register forward fill — the systolic simulator's semantics.

    A silent MAC re-emits its previous-cycle output, so the psum flowing past
    it is the one of the last clean streamed row; chained silent cycles keep
    inheriting from the last clean row above (``np.maximum.accumulate`` over
    the last-clean row index, exactly as in
    ``SystolicSim._propagate_vec``).
    """
    m_rows, k, _ = terms.shape
    row_ix = np.arange(m_rows)[:, None]
    out = np.zeros((m_rows, terms.shape[2]), dtype=np.float64)
    for i in range(k):
        out = out + terms[:, i, :]
        sil = silent[:, i, :]
        if sil.any():
            last = np.maximum.accumulate(np.where(sil, -1, row_ix), axis=0)
            filled = np.take_along_axis(out, np.maximum(last, 0), axis=0)
            out = np.where(sil, np.where(last >= 0, filled, 0.0), out)
    return out


@register_corruption("tedrop", tiles=te_drop_tiles)
def te_drop(terms: np.ndarray, silent: np.ndarray,
            rng: np.random.Generator) -> np.ndarray:
    """TE-Drop: the failing MAC's rank-1 contribution is zeroed; the partial
    sum rides past it unchanged."""
    return np.where(silent, 0.0, terms).sum(axis=1)


@register_corruption("bitflip", tiles=bit_flip_tiles)
def bit_flip(terms: np.ndarray, silent: np.ndarray,
             rng: np.random.Generator, *, bit: int = 40) -> np.ndarray:
    """Flip one mantissa bit of every output element whose column saw a
    silent failure.  Bit 40 of the float64 mantissa gives a ~2^-12 relative
    perturbation — noticeable but finite (exponent bits would explode)."""
    out = np.ascontiguousarray(terms.sum(axis=1), dtype=np.float64)
    hit = silent.any(axis=1)
    if hit.any():
        raw = out.view(np.int64)
        raw ^= np.where(hit, np.int64(1) << bit, np.int64(0))
    return out
