"""Reference (loop) implementations of the paper's four clustering algorithms.

These are the original interpreted-Python implementations, kept verbatim as
bit-exact oracles for the vectorized rewrites in :mod:`repro_torch.core.clustering`.
They are intentionally slow (hierarchical is O(n^3) with per-merge submatrix
copies) — use them only for equivalence testing and the ``impl="reference"``
benchmark baseline, never on a hot path.

Every function returns integer labels of shape ``(n,)``; DBSCAN additionally
uses ``-1`` for noise.  All are deterministic given ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional, Tuple

import numpy as np


def _as2d(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[:, None] if x.ndim == 1 else x


def _pairwise_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(
        (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * a @ b.T, 0.0)


# ---------------------------------------------------------------------------
# Hierarchical agglomerative (Sec. IV-A)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Dendrogram:
    """Merge history: row i merges clusters ``left[i]``, ``right[i]`` at
    ``height[i]`` producing cluster ``n + i`` of size ``size[i]`` (scipy-like)."""

    left: np.ndarray
    right: np.ndarray
    height: np.ndarray
    size: np.ndarray

    def cut(self, n_clusters: int) -> np.ndarray:
        """Labels from cutting the tree to ``n_clusters``."""
        n = len(self.left) + 1
        parent = list(range(n + len(self.left)))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        keep = len(self.left) - (n_clusters - 1)
        for m in range(max(keep, 0)):
            new = n + m
            parent[find(int(self.left[m]))] = new
            parent[find(int(self.right[m]))] = new
        roots = {find(i) for i in range(n)}
        remap = {r: k for k, r in enumerate(sorted(roots))}
        return np.array([remap[find(i)] for i in range(n)], dtype=np.int64)


Linkage = Literal["single", "complete", "average"]


def hierarchical(x: np.ndarray, n_clusters: int = 4,
                 linkage: Linkage = "average") -> np.ndarray:
    """Agglomerative clustering; returns labels."""
    return hierarchical_dendrogram(x, linkage=linkage).cut(n_clusters)


def hierarchical_dendrogram(x: np.ndarray, linkage: Linkage = "average") -> Dendrogram:
    """Full merge history (the paper's Fig. 10 dendrogram). O(n^3) worst case —
    fine for the <= 4096 MACs of a 64x64 array."""
    pts = _as2d(x)
    n = len(pts)
    d = np.sqrt(_pairwise_sq(pts, pts))
    np.fill_diagonal(d, np.inf)
    active = {i: i for i in range(n)}          # position -> cluster id
    sizes = {i: 1 for i in range(n)}
    alive = list(range(n))
    left: List[int] = []
    right: List[int] = []
    height: List[float] = []
    msize: List[int] = []
    next_id = n
    dist = d.copy()
    for _ in range(n - 1):
        sub = dist[np.ix_(alive, alive)]
        k = int(np.argmin(sub))
        ai, bi = divmod(k, len(alive))
        if ai > bi:
            ai, bi = bi, ai
        pa, pb = alive[ai], alive[bi]
        h = float(sub[ai, bi])
        ca, cb = active[pa], active[pb]
        sa, sb = sizes[ca], sizes[cb]
        # update distances from merged cluster (stored at slot pa) to the rest
        da, db = dist[pa], dist[pb]
        if linkage == "single":
            nd = np.minimum(da, db)
        elif linkage == "complete":
            nd = np.where(np.isinf(da) | np.isinf(db), np.inf, np.maximum(da, db))
        else:  # average
            nd = (sa * da + sb * db) / (sa + sb)
        dist[pa, :] = nd
        dist[:, pa] = nd
        dist[pa, pa] = np.inf
        dist[pb, :] = np.inf
        dist[:, pb] = np.inf
        alive.remove(pb)
        left.append(min(ca, cb))
        right.append(max(ca, cb))
        height.append(h)
        msize.append(sa + sb)
        active[pa] = next_id
        sizes[next_id] = sa + sb
        next_id += 1
    return Dendrogram(np.array(left), np.array(right), np.array(height),
                      np.array(msize))


# ---------------------------------------------------------------------------
# K-means++ (Sec. IV-B)
# ---------------------------------------------------------------------------


def kmeans(x: np.ndarray, k: int = 4, seed: int = 0, iters: int = 100,
           return_centers: bool = False):
    """Lloyd's algorithm with k-means++ seeding [Arthur & Vassilvitskii 2007]."""
    pts = _as2d(x)
    n = len(pts)
    if k >= n:
        labels = np.arange(n, dtype=np.int64) % max(k, 1)
        return (labels, pts.copy()) if return_centers else labels
    rng = np.random.default_rng(seed)
    centers = np.empty((k, pts.shape[1]))
    centers[0] = pts[rng.integers(n)]
    d2 = _pairwise_sq(pts, centers[:1]).min(-1)
    for c in range(1, k):
        tot = d2.sum()
        probs = d2 / tot if tot > 0 else np.full(n, 1.0 / n)
        centers[c] = pts[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, _pairwise_sq(pts, centers[c:c + 1]).min(-1))
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        newl = np.argmin(_pairwise_sq(pts, centers), axis=-1)
        if np.array_equal(newl, labels) and _ > 0:
            break
        labels = newl
        for c in range(k):
            m = labels == c
            if m.any():
                centers[c] = pts[m].mean(0)
            else:  # re-seed empty cluster at the farthest point
                centers[c] = pts[int(np.argmax(_pairwise_sq(pts, centers).min(-1)))]
    return (labels, centers) if return_centers else labels


# ---------------------------------------------------------------------------
# Mean-shift (Sec. IV-C)
# ---------------------------------------------------------------------------


def meanshift(x: np.ndarray, bandwidth: float = 0.4, iters: int = 200,
              tol: float = 1e-6, kernel: str = "flat") -> np.ndarray:
    """Mean-shift clustering; the paper sets the window radius to 0.4 for the
    16x16 array's slacks (Sec. IV-C).  ``kernel='flat'`` is the classic
    fixed-radius window whose radius matches the paper's usage; 'gaussian'
    (RBF) is also provided."""
    pts = _as2d(x)
    modes = pts.copy()
    for _ in range(iters):
        d2 = _pairwise_sq(modes, pts)
        if kernel == "flat":
            w = (d2 <= bandwidth * bandwidth).astype(np.float64)
        else:
            w = np.exp(-0.5 * d2 / (bandwidth ** 2))
        new = (w @ pts) / np.maximum(w.sum(-1, keepdims=True), 1e-300)
        shift = np.abs(new - modes).max()
        modes = new
        if shift < tol:
            break
    # merge modes closer than bandwidth/2
    labels = -np.ones(len(pts), dtype=np.int64)
    centers: List[np.ndarray] = []
    for i, m in enumerate(modes):
        for c, ctr in enumerate(centers):
            if np.linalg.norm(m - ctr) < bandwidth / 2:
                labels[i] = c
                break
        else:
            centers.append(m)
            labels[i] = len(centers) - 1
    return labels


# ---------------------------------------------------------------------------
# DBSCAN (Sec. IV-D) — the paper's preferred algorithm
# ---------------------------------------------------------------------------


def dbscan(x: np.ndarray, eps: float = 0.12, min_pts: int = 8) -> np.ndarray:
    """Density-based clustering; label -1 marks noise/outlier MACs."""
    pts = _as2d(x)
    n = len(pts)
    d2 = _pairwise_sq(pts, pts)
    neigh = d2 <= eps * eps
    core = neigh.sum(-1) >= min_pts          # self-inclusive, as sklearn
    labels = np.full(n, -1, dtype=np.int64)
    cid = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS over density-reachable points
        stack = [i]
        labels[i] = cid
        while stack:
            p = stack.pop()
            if not core[p]:
                continue
            for q in np.flatnonzero(neigh[p]):
                if labels[q] == -1:
                    labels[q] = cid
                    stack.append(int(q))
        cid += 1
    return labels


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def cluster(x: np.ndarray, algo: str = "dbscan", **kw) -> np.ndarray:
    """Dispatch by algorithm name (paper's 'Choice of Clustering Algorithms')."""
    algo = algo.lower()
    if algo in ("hierarchical", "hierarchy"):
        return hierarchical(x, **kw)
    if algo in ("kmeans", "k-means", "k_means"):
        return kmeans(x, **kw)
    if algo in ("meanshift", "mean-shift", "mean_shift"):
        return meanshift(x, **kw)
    if algo == "dbscan":
        return dbscan(x, **kw)
    raise ValueError(f"unknown clustering algorithm: {algo!r}")


def relabel_by_feature_mean(x: np.ndarray, labels: np.ndarray,
                            descending: bool = True) -> np.ndarray:
    """Renumber clusters so cluster 0 has the highest (default) mean feature.

    With slack as the feature this makes cluster 0 the *highest-slack* group,
    which the paper places in the *lowest-voltage* partition. Noise (-1) stays.
    """
    x = np.asarray(x, dtype=np.float64).reshape(len(labels), -1).mean(-1)
    ids = [c for c in np.unique(labels) if c != -1]
    means = {c: x[labels == c].mean() for c in ids}
    order = sorted(ids, key=lambda c: means[c], reverse=descending)
    remap = {c: r for r, c in enumerate(order)}
    out = labels.copy()
    for c, r in remap.items():
        out[labels == c] = r
    return out


def attach_noise_to_nearest(x: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Assign DBSCAN noise points to the nearest cluster centroid.

    The paper treats outlier MACs as noise at clustering time, but *every* MAC
    must live in some voltage partition, so noise is folded into its nearest
    cluster before floorplanning.
    """
    pts = _as2d(x)
    ids = [c for c in np.unique(labels) if c != -1]
    if not ids:
        return np.zeros(len(labels), dtype=np.int64)
    cents = np.stack([pts[labels == c].mean(0) for c in ids])
    out = labels.copy()
    noise = labels == -1
    if noise.any():
        nearest = np.argmin(_pairwise_sq(pts[noise], cents), axis=-1)
        out[noise] = np.array(ids)[nearest]
    return out


def silhouette(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient (used by tests/benchmarks to sanity-check
    cluster quality across the four algorithms)."""
    pts = _as2d(x)
    ids = [c for c in np.unique(labels) if c != -1]
    if len(ids) < 2:
        return 0.0
    d = np.sqrt(_pairwise_sq(pts, pts))
    vals = []
    for i in range(len(pts)):
        li = labels[i]
        if li == -1:
            continue
        own = labels == li
        own[i] = False
        if not own.any():
            continue
        a = d[i][own].mean()
        b = min(d[i][labels == c].mean() for c in ids if c != li)
        vals.append((b - a) / max(a, b))
    return float(np.mean(vals)) if vals else 0.0
