"""The paper's four clustering algorithms (Sec. IV), vectorized NumPy.

scikit-learn is not available in this container, so Hierarchical agglomerative,
K-means(++), Mean-shift and DBSCAN are implemented directly.  All operate on
1-D minimum-slack vectors (shape ``(n,)``) or general ``(n, d)`` features.

These are the array-programming rewrites of the original loop implementations,
which are preserved verbatim in :mod:`repro_torch.core.clustering_ref` as bit-exact
oracles (``tests/core/test_clustering_equiv.py`` asserts label identity):

  * agglomerative keeps a per-row nearest-neighbour cache so each merge costs
    O(n) instead of an O(n^2) submatrix copy + argmin (the old
    ``np.ix_``/``alive.remove`` bookkeeping) — ~1000x at 64x64;
  * DBSCAN grows whole frontiers with boolean-matrix reachability instead of a
    per-point stack;
  * k-means updates all centroids in one ``np.bincount`` batch;
  * mean-shift merges modes one center-sweep at a time instead of per point;
  * the relabel/noise/silhouette helpers are single-pass ``np.bincount``.

Every function returns integer labels of shape ``(n,)``; DBSCAN additionally
uses ``-1`` for noise.  All are deterministic given ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

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
        parent = np.arange(n + len(self.left), dtype=np.int64)

        keep = len(self.left) - (n_clusters - 1)
        for m in range(max(keep, 0)):
            new = n + m
            for node in (int(self.left[m]), int(self.right[m])):
                while parent[node] != node:          # find with path halving
                    parent[node] = parent[parent[node]]
                    node = parent[node]
                parent[node] = new
        # vectorized path compression: pointer-jump every leaf to its root
        roots = parent[np.arange(n)]
        nxt = parent[roots]
        while (nxt != roots).any():
            roots = nxt
            nxt = parent[parent[roots]]
        # renumber sorted roots to 0..k-1 (same map as the reference dict)
        _, labels = np.unique(roots, return_inverse=True)
        return labels.astype(np.int64)


Linkage = Literal["single", "complete", "average"]


def hierarchical(x: np.ndarray, n_clusters: int = 4,
                 linkage: Linkage = "average") -> np.ndarray:
    """Agglomerative clustering; returns labels."""
    return hierarchical_dendrogram(x, linkage=linkage).cut(n_clusters)


def hierarchical_dendrogram(x: np.ndarray, linkage: Linkage = "average") -> Dendrogram:
    """Full merge history (the paper's Fig. 10 dendrogram).

    Nearest-neighbour-cached greedy merging: the full distance matrix is kept
    masked in place (dead rows/columns pinned at ``inf``) with a per-row
    (min, argmin) cache, so each merge is O(n) plus a batched re-scan of only
    the rows whose cached neighbour was invalidated.  Merge order, linkage
    updates and tie-breaking (row-major first occurrence) replicate
    :func:`repro_torch.core.clustering_ref.hierarchical_dendrogram` bit for bit.
    """
    pts = _as2d(x)
    n = len(pts)
    dist = np.sqrt(_pairwise_sq(pts, pts))
    np.fill_diagonal(dist, np.inf)

    alive = np.ones(n, dtype=bool)
    active = np.arange(n, dtype=np.int64)        # slot -> cluster id
    slot_size = np.ones(n, dtype=np.int64)       # slot -> cluster size
    row_min = dist.min(axis=1)
    row_arg = dist.argmin(axis=1)

    left = np.empty(n - 1, dtype=np.int64)
    right = np.empty(n - 1, dtype=np.int64)
    height = np.empty(n - 1, dtype=np.float64)
    msize = np.empty(n - 1, dtype=np.int64)
    idx = np.arange(n)

    for m in range(n - 1):
        i_star = int(np.argmin(row_min))          # first row holding the min
        j_star = int(row_arg[i_star])             # first column in that row
        pa, pb = (i_star, j_star) if i_star < j_star else (j_star, i_star)
        h = float(dist[i_star, j_star])
        ca, cb = int(active[pa]), int(active[pb])
        sa, sb = int(slot_size[pa]), int(slot_size[pb])

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
        alive[pb] = False
        row_min[pb] = np.inf

        left[m] = min(ca, cb)
        right[m] = max(ca, cb)
        height[m] = h
        msize[m] = sa + sb
        active[pa] = n + m
        slot_size[pa] = sa + sb

        # repair the row cache: rows whose cached neighbour was pa or pb must
        # re-scan; for the rest the only changed column is pa (distance nd)
        others = alive & (idx != pa)
        stale = others & ((row_arg == pa) | (row_arg == pb))
        stale[pa] = alive[pa]                     # pa's whole row changed
        fix = np.flatnonzero(stale)
        if fix.size:
            sub = dist[fix]
            args = sub.argmin(axis=1)
            row_arg[fix] = args
            row_min[fix] = sub[np.arange(fix.size), args]
        fresh = others & ~stale
        npa = nd[fresh]
        better = npa < row_min[fresh]
        tie = npa == row_min[fresh]
        fresh_ix = np.flatnonzero(fresh)
        row_min[fresh_ix[better]] = npa[better]
        row_arg[fresh_ix[better]] = pa
        # an exact tie moves the first occurrence only if pa is earlier
        row_arg[fresh_ix[tie]] = np.minimum(row_arg[fresh_ix[tie]], pa)

    return Dendrogram(left, right, height, msize)


# ---------------------------------------------------------------------------
# K-means++ (Sec. IV-B)
# ---------------------------------------------------------------------------


def kmeans(x: np.ndarray, k: int = 4, seed: int = 0, iters: int = 100,
           return_centers: bool = False):
    """Lloyd's algorithm with k-means++ seeding [Arthur & Vassilvitskii 2007].

    Centroid updates are batched over all clusters with ``np.bincount``; the
    empty-cluster re-seed walks clusters in index order exactly like the
    reference (each re-seed sees the centers updated so far).  Note the
    bincount sums accumulate sequentially while the reference's ``mean(0)``
    sums pairwise — centroids can differ in the last ulp, which changes
    labels only if a point sits within ~1 ulp of equidistant between two
    centroids (never observed on the flow's slack data; the equivalence
    suite pins it across seeds and sizes).
    """
    pts = _as2d(x)
    n, d = pts.shape
    if k >= n:
        labels = np.arange(n, dtype=np.int64) % max(k, 1)
        return (labels, pts.copy()) if return_centers else labels
    rng = np.random.default_rng(seed)
    centers = np.empty((k, d))
    centers[0] = pts[rng.integers(n)]
    d2 = _pairwise_sq(pts, centers[:1]).min(-1)
    for c in range(1, k):
        tot = d2.sum()
        probs = d2 / tot if tot > 0 else np.full(n, 1.0 / n)
        centers[c] = pts[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, _pairwise_sq(pts, centers[c:c + 1]).min(-1))
    labels = np.zeros(n, dtype=np.int64)
    for it in range(iters):
        newl = np.argmin(_pairwise_sq(pts, centers), axis=-1)
        if np.array_equal(newl, labels) and it > 0:
            break
        labels = newl
        counts = np.bincount(labels, minlength=k)
        sums = np.stack([np.bincount(labels, weights=pts[:, j], minlength=k)
                         for j in range(d)], axis=1)
        means = sums / np.maximum(counts, 1)[:, None]
        nonempty = counts > 0
        if nonempty.all():
            centers = means
        else:
            for c in range(k):                    # reference re-seed order
                if nonempty[c]:
                    centers[c] = means[c]
                else:
                    centers[c] = pts[int(np.argmax(
                        _pairwise_sq(pts, centers).min(-1)))]
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
    # merge modes closer than bandwidth/2: sweep one center at a time — the
    # earliest unassigned mode founds the next center and claims every
    # unassigned mode within bandwidth/2, which is exactly the reference's
    # "join the first close-enough center" order
    n = len(pts)
    labels = -np.ones(n, dtype=np.int64)
    unassigned = np.ones(n, dtype=bool)
    cid = 0
    while unassigned.any():
        i = int(np.argmax(unassigned))
        ctr = modes[i]
        close = np.sqrt(((modes - ctr) ** 2).sum(-1)) < bandwidth / 2
        members = unassigned & close
        members[i] = True
        labels[members] = cid
        unassigned &= ~members
        cid += 1
    return labels


# ---------------------------------------------------------------------------
# DBSCAN (Sec. IV-D) — the paper's preferred algorithm
# ---------------------------------------------------------------------------


def dbscan(x: np.ndarray, eps: float = 0.12, min_pts: int = 8) -> np.ndarray:
    """Density-based clustering; label -1 marks noise/outlier MACs.

    Region growth expands whole frontiers at once: each step ORs together the
    neighbourhood rows of every core point on the frontier instead of popping
    points off a stack.  Cluster ids still appear in ascending order of each
    component's smallest core index, and a border point in reach of several
    clusters keeps the earliest id — the reference's DFS semantics.
    """
    pts = _as2d(x)
    n = len(pts)
    d2 = _pairwise_sq(pts, pts)
    neigh = d2 <= eps * eps
    core = neigh.sum(-1) >= min_pts          # self-inclusive, as sklearn
    labels = np.full(n, -1, dtype=np.int64)
    cid = 0
    unvisited_core = core.copy()
    while unvisited_core.any():
        seed = int(np.argmax(unvisited_core))
        members = np.zeros(n, dtype=bool)
        members[seed] = True
        frontier = members.copy()            # frontier always core-only
        while frontier.any():
            reached = neigh[frontier].any(axis=0)
            new = reached & ~members & (labels == -1)
            members |= new
            frontier = new & core
        labels[members] = cid
        unvisited_core &= ~members
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

    A ``np.bincount`` presence pass replaces the ``np.unique`` sort and one
    array gather replaces the old per-cluster remap rescans.  The k cluster
    means deciding the *ordering* deliberately use the oracle's exact
    arithmetic (``x[labels == c].mean()``, pairwise summation): a
    bincount-accumulated sum rounds differently in the last ulp, and a
    near-tie between cluster means must never permute labels between the
    vectorized and reference paths (the flow benchmark gates on bit-identical
    reports).
    """
    x = np.asarray(x, dtype=np.float64).reshape(len(labels), -1).mean(-1)
    mask = labels != -1
    if not mask.any():
        return labels.copy()
    ids = np.flatnonzero(np.bincount(labels[mask]))
    means = np.array([x[labels == c].mean() for c in ids])
    # stable sort keeps ascending id order on exact ties, like sorted()
    order = ids[np.argsort(-means if descending else means, kind="stable")]
    remap = np.empty(int(labels.max()) + 1, dtype=np.int64)
    remap[order] = np.arange(order.size)
    out = labels.copy()
    out[mask] = remap[labels[mask]]
    return out


def attach_noise_to_nearest(x: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Assign DBSCAN noise points to the nearest cluster centroid.

    The paper treats outlier MACs as noise at clustering time, but *every* MAC
    must live in some voltage partition, so noise is folded into its nearest
    cluster before floorplanning.  Centroids keep the oracle's exact
    per-cluster ``mean(0)`` (see :func:`relabel_by_feature_mean` for why);
    the noise-to-centroid assignment is the batched part.
    """
    pts = _as2d(x)
    mask = labels != -1
    if not mask.any():
        return np.zeros(len(labels), dtype=np.int64)
    ids = np.flatnonzero(np.bincount(labels[mask]))
    cents = np.stack([pts[labels == c].mean(0) for c in ids])
    out = labels.copy()
    noise = ~mask
    if noise.any():
        nearest = np.argmin(_pairwise_sq(pts[noise], cents), axis=-1)
        out[noise] = ids[nearest]
    return out


def silhouette(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient (used by tests/benchmarks to sanity-check
    cluster quality across the four algorithms)."""
    pts = _as2d(x)
    labels = np.asarray(labels)
    mask = labels != -1
    counts = np.bincount(labels[mask]) if mask.any() else np.zeros(0, np.int64)
    ids = np.flatnonzero(counts)
    if ids.size < 2:
        return 0.0
    d = np.sqrt(_pairwise_sq(pts, pts))
    onehot = np.zeros((len(pts), int(labels.max()) + 1))
    onehot[mask, labels[mask]] = 1.0
    sums = d @ onehot                                  # (n, max_id+1)
    valid = mask & (counts[np.maximum(labels, 0)] > 1) & (labels >= 0)
    li = labels[valid]
    a = sums[valid, li] / (counts[li] - 1)             # d[i, i] = 0, excluded
    mean_to = sums[valid][:, ids] / counts[ids][None, :]
    own_col = np.searchsorted(ids, li)
    mean_to[np.arange(len(li)), own_col] = np.inf      # exclude own cluster
    b = mean_to.min(axis=1)
    if a.size == 0:
        return 0.0
    return float(np.mean((b - a) / np.maximum(a, b)))
