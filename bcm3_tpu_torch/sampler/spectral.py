"""Density-aware spectral clustering of the sample history, on torch tensors.

Counterpart of bcm3_tpu/sampler/spectral.py (reference:
src/sampler/SampleHistoryClustering.cpp). The fit runs on the host at an
adaptation boundary and is the JAX package's numpy code, copied, so the
same `np.random.Generator` gives the same fit bit for bit; its result is
moved to the sampler's device as float64 tensors. One step of it runs on
that device instead: finding the distinct history rows, which
`np.unique(axis=0)` takes 13-16 s to do on the host for the 2.7 M rows of
bench.py's adapted width (`_first_unique_rows` finds the same rows). The assignment of new
points runs on that device in batches of rows, in two formulas, each
held to its own counterpart in the JAX package (they differ at rounding):

- `assign_batch`, the mutate path's assignment of the chain population
  (the JAX package's `assign_batch`): direct differences to the stored
  samples, the `needed + 1` nearest by `topk`, no clamp;
- `assign_history`, the boundary's labelling of history rows (the JAX
  package's `assign_host`, a Python loop over rows there):
  |s|^2 + |y|^2 - 2 s.y clamped at 0, the neighbour scale clamped at
  1e-24.

Both work in chunks of rows so that no intermediate exceeds `max_bytes`,
and both count a query's common neighbours as the sum of the nn2 rows of
the transposed neighbour bitset that its nearest samples pick: the JAX
package's (n, n) . (n,) product with a 0/1 indicator, summed exactly
(integer counts in float64) at nn2 / n of the work.

Algorithm (as the reference):
1. scale variables by their history standard deviation;
2. density-aware kernel: per-sample scale = distance to the nn-th nearest
   neighbour; K(i, j) = exp(-d2(i, j) / (s_i * s_j * (cnns + 1))) where
   cnns counts common members of the nn2-nearest-neighbour lists
   (SampleHistoryClustering.cpp:123-164);
3. normalized graph Laplacian D^-1/2 K D^-1/2, top-k eigenvectors,
   row-normalized (:172-190);
4. k-means on the spectral embedding (:198);
5. out-of-sample points: kernel row against the stored samples, projected
   onto the spectral embedding, assigned to the centroid with the largest
   dot product (:244-305).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# bytes of the largest intermediate of one chunk of rows
CHUNK_BYTES = 1 << 30


@dataclass
class ClusterAssigner:
    """Float64 tensors, on the device that assigns, for out-of-sample
    cluster assignment."""

    variable_scaling: torch.Tensor  # (D,)
    scaled_samples: torch.Tensor  # (n, D)
    sample_scale: torch.Tensor  # (n,)
    nn_bitset: torch.Tensor  # (n, n): [si, j] = 1 if j is in si's nn2-NN list
    spectral: torch.Tensor  # (n, k) row-normalized top-k eigenvectors
    centroids: torch.Tensor  # (k, k) k-means centroids in spectral space
    nn: int = 3
    nn2: int = 7
    # nn_bitset transposed, contiguous: row j marks the samples whose
    # nn2-NN list holds j
    bitset_t: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.bitset_t = self.nn_bitset.t().contiguous()

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    def to(self, device) -> "ClusterAssigner":
        return ClusterAssigner(
            **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS}, nn=self.nn, nn2=self.nn2
        )


ARRAY_FIELDS = (
    "variable_scaling", "scaled_samples", "sample_scale", "nn_bitset", "spectral", "centroids",
)


def _centroid_scores(a: ClusterAssigner, dists, scale, nearest):
    """(c, k) scores of each centroid for c queries, from their (c, n)
    squared distances to the stored samples, (c,) neighbour scales and
    (c, nn2) nearest stored samples (reference: :281-305)."""
    cnns = a.bitset_t[nearest[:, 0]]
    for j in range(1, nearest.shape[1]):
        cnns = cnns + a.bitset_t[nearest[:, j]]
    B = torch.exp(-dists / (scale[:, None] * a.sample_scale * (cnns + 1.0)))
    f = B @ a.spectral  # (c, k)
    return f @ a.centroids.T


def batch_scores(a: ClusterAssigner, xs: torch.Tensor, max_bytes: int = CHUNK_BYTES):
    """Centroid scores of `assign_batch`, (C, k) float64, for xs: (C, D)."""
    n, D = a.scaled_samples.shape
    needed = max(a.nn, a.nn2)
    rows = max(1, max_bytes // (n * D * 8))
    out = []
    for s in range(0, len(xs), rows):
        y = xs[s : s + rows].to(torch.float64) / a.variable_scaling
        d = a.scaled_samples[None] - y[:, None, :]  # (c, n, D)
        dists = d.square_().sum(dim=-1)
        del d
        # the query is not among the stored samples, so index nn is its
        # nn-th neighbour (reference: :281)
        near_d, near = torch.topk(dists, needed + 1, dim=-1, largest=False)
        scale = torch.sqrt(near_d[:, a.nn])
        out.append(_centroid_scores(a, dists, scale, near[:, : a.nn2]))
    return torch.cat(out) if out else xs.new_zeros((0, a.num_clusters), dtype=torch.float64)


def assign_batch(a: ClusterAssigner, xs: torch.Tensor, max_bytes: int = CHUNK_BYTES):
    """Cluster index of every row of xs: (C, D) -> (C,) int64
    (reference: SampleHistoryClustering.cpp GetSampleCluster:244-305)."""
    return torch.argmax(batch_scores(a, xs, max_bytes), dim=-1)


def history_scores(a: ClusterAssigner, xs: torch.Tensor, max_bytes: int = CHUNK_BYTES):
    """Centroid scores of `assign_history`, (N, k) float64, for xs: (N, D).
    The nearest samples are the first entries of the distances' argsort,
    taken by `topk` (the same entries where the distances are distinct)."""
    n = a.scaled_samples.shape[0]
    sq_s = (a.scaled_samples**2).sum(dim=1)
    first = max(a.nn + 1, a.nn2)
    rows = max(1, max_bytes // (n * 8))
    out = []
    for s in range(0, len(xs), rows):
        y = xs[s : s + rows].to(torch.float64) / a.variable_scaling
        dists = torch.clamp(
            (sq_s + (y**2).sum(dim=1, keepdim=True)) - 2.0 * (y @ a.scaled_samples.T), min=0.0
        )
        near_d, near = torch.topk(dists, first, dim=-1, largest=False)
        scale = torch.sqrt(torch.clamp(near_d[:, a.nn], min=1e-24))
        out.append(_centroid_scores(a, dists, scale, near[:, : a.nn2]))
    return torch.cat(out) if out else xs.new_zeros((0, a.num_clusters), dtype=torch.float64)


def assign_history(a: ClusterAssigner, xs: torch.Tensor, max_bytes: int = CHUNK_BYTES):
    """Cluster labels of history rows xs: (N, D) -> (N,) int64 (reference:
    SampleHistoryClustering.cpp AssignAllHistorySamples:232-246)."""
    return torch.argmax(history_scores(a, xs, max_bytes), dim=-1)


# ---------------------------------------------------------------------------
# Host-side fit (numpy, as the JAX package's)


def _first_unique_rows(rows: np.ndarray, device) -> np.ndarray:
    """Indices of the first occurrence of each distinct row, ascending: what
    np.unique(rows, axis=0, return_index=True) gives, sorted. Rows are
    equal where every entry compares equal, in both."""
    t = torch.as_tensor(rows, device=device)
    _, inverse = torch.unique(t, dim=0, return_inverse=True)
    order = torch.arange(len(t), device=device)
    first = torch.full((int(inverse.max()) + 1,), len(t), device=device)
    first.scatter_reduce_(0, inverse, order, "amin")
    return np.sort(first.cpu().numpy())


def _naive_kmeans(
    Y: np.ndarray, k: int, restarts: int, iters: int, rng: np.random.Generator
):
    """Plain k-means with random-point init, best of ``restarts``
    (reference: src/utils/Clustering.cpp NaiveKMeans)."""
    n = len(Y)
    best = None
    for _ in range(restarts):
        centroids = Y[rng.choice(n, size=k, replace=False)].copy()
        assignment = np.zeros(n, dtype=np.int64)
        for _it in range(iters):
            d = ((Y[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
            new_assignment = d.argmin(axis=1)
            if np.array_equal(new_assignment, assignment) and _it > 0:
                break
            assignment = new_assignment
            for ci in range(k):
                sel = Y[assignment == ci]
                if len(sel):
                    centroids[ci] = sel.mean(axis=0)
        inertia = (
            ((Y - centroids[assignment]) ** 2).sum()
            if len(np.unique(assignment)) == k
            else np.inf
        )
        if best is None or inertia < best[0]:
            best = (inertia, centroids.copy(), assignment.copy())
    if best is None or not np.isfinite(best[0]):
        return None
    return best[1], best[2]


def fit_spectral_clustering(
    history: np.ndarray,
    nn: int,
    nn2: int,
    num_clusters: int,
    max_samples: int,
    rng: np.random.Generator,
    device="cuda",
    discard_first: int = 0,
    dump_sink: Optional[dict] = None,
) -> Optional[ClusterAssigner]:
    """Fit the density-aware spectral clustering on a (N, D) history matrix
    on the host (its distinct rows found on `device`, the card unless the
    caller asks for the CPU); the ClusterAssigner's tensors are put on
    `device`. None if
    the history is degenerate (reference: SampleHistoryClustering.cpp
    Cluster:28-228).

    When ``dump_sink`` is a dict, the fit's intermediates are stored in it
    under the reference's sample_history_clustering.nc names
    (SampleHistoryClustering.cpp:119-120,168,193,206): the scaled unique
    input samples, the per-variable scaling, the kernel matrix K, the
    spectral embedding Y, and the k-means assignment of the input samples.
    """
    history = np.asarray(history, dtype=np.float64)
    if history.ndim != 2 or len(history) < 1:
        return None
    scaling = history.std(axis=0, ddof=1)
    if np.any(~np.isfinite(scaling)) or np.any(scaling <= 0.0):
        return None

    # unique samples (float32 tolerance like the reference's epsilon test),
    # burn-in discard, random downsample to max_samples
    uniq_ix = _first_unique_rows(history[discard_first:].astype(np.float32), device)
    if len(uniq_ix) < nn2 + 1:
        return None
    if len(uniq_ix) > max_samples:
        uniq_ix = np.sort(rng.choice(uniq_ix, size=max_samples, replace=False))
    scaled = history[discard_first:][uniq_ix] / scaling
    n = len(scaled)

    # pairwise squared distances
    sq = (scaled**2).sum(axis=1)
    D2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * scaled @ scaled.T, 0.0)
    np.fill_diagonal(D2, 0.0)

    order = np.argsort(D2, axis=1)  # row ordering; self at position 0
    sample_scale = np.sqrt(D2[np.arange(n), order[:, nn]])
    if np.any(sample_scale == 0.0):
        sample_scale = np.maximum(sample_scale, 1e-12)
    nn_lists = order[:, 1 : nn2 + 1]  # (n, nn2), excluding self
    bitset = np.zeros((n, n))
    bitset[np.arange(n)[:, None], nn_lists] = 1.0

    # common-nearest-neighbour counts: cnns(si,sj) = |nn_list(sj) ∩ nn_list(si)|
    cnns = bitset @ bitset.T
    K = np.exp(-D2 / (np.outer(sample_scale, sample_scale) * (cnns + 1.0)))
    np.fill_diagonal(K, 0.0)

    row_sum = K.sum(axis=1)
    if np.any(row_sum <= 0.0):
        return None
    dinv = 1.0 / np.sqrt(row_sum)
    L = K * np.outer(dinv, dinv)
    evals, evecs = np.linalg.eigh(L)
    Y = evecs[:, ::-1][:, :num_clusters]  # top-k eigenvectors
    norms = np.sqrt(np.maximum((Y**2).sum(axis=1), np.finfo(float).eps))
    Y = Y / norms[:, None]

    km = _naive_kmeans(Y, num_clusters, restarts=10, iters=100, rng=rng)
    if km is None:
        # the reference falls back to random assignment; for the batched
        # design a degenerate clustering is not useful, so report failure
        return None
    centroids, _assignment = km

    if dump_sink is not None:
        dump_sink["clustering_input_samples"] = scaled.copy()
        dump_sink["clustering_input_sample_scaling"] = scaling.copy()
        dump_sink["K"] = K.copy()
        dump_sink["Y"] = Y.copy()
        dump_sink["assignment"] = _assignment.astype(np.int32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return ClusterAssigner(
        variable_scaling=t(scaling),
        scaled_samples=t(scaled),
        sample_scale=t(sample_scale),
        nn_bitset=t(bitset),
        spectral=t(Y),
        centroids=t(centroids),
        nn=nn,
        nn2=nn2,
    )
