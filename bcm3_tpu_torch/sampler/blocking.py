"""Variable blocking strategies.

TPU-native equivalent of the reference blocking hierarchy
(reference: src/sampler/BlockingStrategy*.cpp). Blocks are computed on
the host at adaptation boundaries from the device sample history and
become the static structure of the next jitted sampling segment.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform


def one_block(num_variables: int) -> List[np.ndarray]:
    """All variables in a single block (reference: BlockingStrategyOneBlock)."""
    return [np.arange(num_variables)]


def no_blocking(num_variables: int) -> List[np.ndarray]:
    """One variable per block (reference: BlockingStrategyNoBlocking)."""
    return [np.array([i]) for i in range(num_variables)]


def _tree_cluster_blocks(distance: np.ndarray) -> List[np.ndarray]:
    """Average-linkage hierarchical clustering cut at height 0.5
    (reference: src/utils/Clustering.cpp TreeCluster over cluster-1.52a)."""
    d = distance.copy()
    np.fill_diagonal(d, 0.0)
    d = 0.5 * (d + d.T)  # enforce symmetry for squareform
    z = linkage(squareform(d, checks=False), method="average")
    labels = fcluster(z, t=0.5, criterion="distance")
    blocks = []
    for lab in np.unique(labels):
        blocks.append(np.where(labels == lab)[0])
    return blocks


def turek(history: Optional[np.ndarray], num_variables: int) -> List[np.ndarray]:
    """Blocks from hierarchical clustering of 1 - |correlation| distance
    (reference: BlockingStrategyTurek.cpp:8-41)."""
    if history is None or len(history) <= 2:
        return no_blocking(num_variables)
    corr = np.corrcoef(np.asarray(history, dtype=np.float64), rowvar=False)
    corr = np.nan_to_num(corr, nan=0.0)
    return _tree_cluster_blocks(1.0 - np.abs(corr))


def clustered_turek(
    history: Optional[np.ndarray],
    cluster_assignment: Optional[np.ndarray],
    num_variables: int,
) -> List[np.ndarray]:
    """Blocks from the max |correlation| across sample clusters
    (reference: BlockingStrategyClusteredTurek.cpp:15-76)."""
    if history is None or len(history) <= 2 or cluster_assignment is None:
        return no_blocking(num_variables)
    history = np.asarray(history, dtype=np.float64)
    max_abs_corr = np.zeros((num_variables, num_variables))
    for lab in np.unique(cluster_assignment):
        sel = history[cluster_assignment == lab]
        if len(sel) < 2:
            continue
        corr = np.corrcoef(sel, rowvar=False)
        corr = np.nan_to_num(corr, nan=0.0)
        max_abs_corr = np.maximum(max_abs_corr, np.abs(corr))
    return _tree_cluster_blocks(1.0 - max_abs_corr)


def get_blocks(
    strategy: str,
    num_variables: int,
    history: Optional[np.ndarray] = None,
    cluster_assignment: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    if strategy == "one_block":
        return one_block(num_variables)
    if strategy == "no_blocking":
        return no_blocking(num_variables)
    if strategy == "Turek":
        return turek(history, num_variables)
    if strategy == "clustered_autoblock":
        return clustered_turek(history, cluster_assignment, num_variables)
    raise ValueError(f"Unknown blocking strategy '{strategy}'")
