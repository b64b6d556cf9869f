"""PhenoGraph-style clustering: kNN -> Jaccard-weighted graph -> Louvain.

CPU re-implementation of the reference's ``phenograph_rapids``
(reference: src/segger/data/utils/neighbors.py:18-51), which uses cuML
NearestNeighbors + cuGraph jaccard + cuGraph louvain; the port's copy of
``segger_tpu.data.clustering``.  NumPy and SciPy only: the exact kNN
gives scikit-learn's ``NearestNeighbors`` neighbour sets (brute force in
float64 above 15 features, a KD-tree below, the query point included),
and the IVF branch's coarse quantizer is the port's own mini-batch
k-means.  Off the training hot path, so CPU is acceptable.
"""
from __future__ import annotations

import logging

import numpy as np
from scipy import sparse as sp
from scipy.spatial import cKDTree

from .. import native
from ..utils_profiling import substage

logger = logging.getLogger(__name__)

# Above this many points, kNN switches from the exact search to the IVF
# approximate search.  Exact kNN on high-dim PCA embeddings is
# effectively O(n^2) on CPU; the IVF path is near-linear and
# BLAS-parallel.
ANN_THRESHOLD = 100_000
# Entries of the two-hop product held at once by
# ``common_neighbor_counts_spgemm`` (about 0.4 GB of int64 values and
# indices).
BLOCK_NNZ = 1 << 25


def exact_knn(X: np.ndarray, k: int) -> np.ndarray:
    """(n, k) indices of each point's k nearest points, itself included,
    nearest first: scikit-learn's ``NearestNeighbors(n_neighbors=k)
    .fit(X).kneighbors(X)``.  Like its 'auto' algorithm, brute force when
    X has more than 15 features or k >= n // 2 (squared distances as
    ``|x|^2 - 2 x.y + |y|^2`` in blocks of queries), else a KD-tree."""
    X = np.asarray(X)
    n, d = X.shape
    if d <= 15 and k < n // 2:
        return cKDTree(X).query(X, k=k)[1].reshape(n, k)
    sq = np.einsum("ij,ij->i", X, X)
    out = np.empty((n, k), dtype=np.int64)
    block = max(1, 16_000_000 // n)       # 128 MB of float64 distances
    for s in range(0, n, block):
        q = X[s:s + block]
        D = sq[s:s + block, None] - 2.0 * (q @ X.T) + sq[None, :]
        part = np.argpartition(D, k - 1, axis=1)[:, :k] if k < n \
            else np.tile(np.arange(n), (len(q), 1))
        dk = np.take_along_axis(D, part, axis=1)
        # nearest first, ties by index
        o = np.lexsort((part, dk), axis=1)
        out[s:s + block] = np.take_along_axis(part, o, axis=1)
    return out


def minibatch_kmeans(
    X: np.ndarray,
    n_clusters: int,
    seed: int = 0,
    batch_size: int = 4096,
    max_iter: int = 100,
    max_no_improvement: int = 10,
) -> np.ndarray:
    """(n_clusters, d) float32 centroids by mini-batch k-means (Sculley
    2010): random initial centers drawn from X, then steps over random
    batches, each center moving to the running mean of the points ever
    assigned to it, for at most ``max_iter`` passes over X and stopping
    once the smoothed batch inertia has not improved for
    ``max_no_improvement`` steps (scikit-learn's ``MiniBatchKMeans``
    schedule, without its reassignment of small clusters)."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    C = X[rng.choice(n, size=n_clusters, replace=False)].copy()
    counts = np.zeros(n_clusters, dtype=np.float64)
    batch_size = min(batch_size, n)
    n_steps = max(1, (max_iter * n) // batch_size)
    alpha = min(1.0, batch_size * 2.0 / (n + 1))
    ewa, best, stale = None, np.inf, 0
    for _ in range(n_steps):
        b = X[rng.integers(0, n, batch_size)]
        D = (C * C).sum(axis=1)[None, :] - 2.0 * (b @ C.T)
        lab = np.argmin(D, axis=1)
        inertia = float(
            (D[np.arange(batch_size), lab] + (b * b).sum(axis=1)).mean())
        cnt = np.bincount(lab, minlength=n_clusters)
        hit = cnt > 0
        sums = np.zeros_like(C, dtype=np.float64)
        np.add.at(sums, lab, b)
        new_counts = counts + cnt
        C[hit] = ((C[hit] * counts[hit, None] + sums[hit])
                  / new_counts[hit, None]).astype(np.float32)
        counts = new_counts
        ewa = inertia if ewa is None else ewa * (1 - alpha) + inertia * alpha
        if ewa < best:
            best, stale = ewa, 0
        else:
            stale += 1
            if stale >= max_no_improvement:
                break
    return C


def _ivf_knn(X: np.ndarray, k: int, seed: int = 0,
             nprobe: int = 8) -> np.ndarray:
    """Approximate kNN via an IVF (inverted-file) coarse quantizer.

    Mini-batch k-means picks ~2*sqrt(n) list centroids; each point is
    scored against the members of its ``nprobe`` nearest lists with
    blocked float32 GEMMs (multi-threaded BLAS), merging a running
    top-k.  Every point is a member of exactly its primary list, so the
    query always finds itself (cuML self-inclusion semantics preserved).
    """
    n, d = X.shape
    Xf = np.ascontiguousarray(X, dtype=np.float32)
    # clamp: 2*sqrt(n) lists, but never more than n//32 (so lists stay
    # usefully populated) and never fewer than 1 (n//32 is 0 for n < 32
    # when a caller forces the ANN path via a tiny ann_threshold)
    nlist = int(np.clip(2 * np.sqrt(n), 1, max(1, n // 32)))
    rng = np.random.default_rng(seed)
    sample = rng.choice(n, size=min(n, 200_000), replace=False)
    C = minibatch_kmeans(Xf[sample], nlist, seed=seed, batch_size=4096,
                         max_iter=100)  # (nlist, d)
    c_sq = (C * C).sum(axis=1)

    nprobe = min(nprobe, nlist)
    probes = np.empty((n, nprobe), dtype=np.int32)
    blk = max(1, 64_000_000 // max(1, nlist))
    for s in range(0, n, blk):
        # squared-distance ranking only needs -2*x.c + |c|^2
        D = c_sq[None, :] - 2.0 * (Xf[s:s + blk] @ C.T)
        part = np.argpartition(D, nprobe - 1, axis=1)[:, :nprobe]
        # exact order within the probe set (primary list first)
        sub = np.take_along_axis(D, part, axis=1)
        probes[s:s + blk] = np.take_along_axis(
            part, np.argsort(sub, axis=1, kind="stable"), axis=1
        )

    primary = probes[:, 0].astype(np.int64)
    order = np.argsort(primary, kind="stable")
    counts = np.bincount(primary, minlength=nlist)
    starts = np.concatenate([[0], np.cumsum(counts)])

    # invert the probe table: queries per list
    q_order = np.argsort(probes.ravel(), kind="stable")
    q_ids = q_order // nprobe
    q_counts = np.bincount(probes.ravel(), minlength=nlist)
    q_starts = np.concatenate([[0], np.cumsum(q_counts)])

    x_sq = (Xf * Xf).sum(axis=1)
    best_d = np.full((n, k), np.inf, dtype=np.float32)
    best_i = np.full((n, k), -1, dtype=np.int64)
    for L in range(nlist):
        m = order[starts[L]:starts[L + 1]]          # members of list L
        q = q_ids[q_starts[L]:q_starts[L + 1]]      # queries probing L
        if len(m) == 0 or len(q) == 0:
            continue
        # block queries so D stays bounded
        qblk = max(1, 16_000_000 // max(1, len(m)))
        for s in range(0, len(q), qblk):
            qq = q[s:s + qblk]
            D = x_sq[m][None, :] - 2.0 * (Xf[qq] @ Xf[m].T)
            kk = min(k, len(m))
            part = np.argpartition(D, kk - 1, axis=1)[:, :kk] \
                if kk < len(m) else np.tile(np.arange(len(m)), (len(qq), 1))
            dloc = np.take_along_axis(D, part, axis=1)
            iloc = m[part]
            alld = np.concatenate([best_d[qq], dloc], axis=1)
            alli = np.concatenate([best_i[qq], iloc], axis=1)
            sel = np.argpartition(alld, k - 1, axis=1)[:, :k]
            best_d[qq] = np.take_along_axis(alld, sel, axis=1)
            best_i[qq] = np.take_along_axis(alli, sel, axis=1)
    # any unfilled slot (tiny lists) degrades to a self edge, which the
    # graph construction drops (no self loops)
    self_col = np.arange(n, dtype=np.int64)[:, None]
    best_i = np.where(best_i < 0, self_col, best_i)
    return best_i


def knn_adjacency(
    X: np.ndarray, n_neighbors: int, ann_threshold: int = ANN_THRESHOLD,
    seed: int = 0,
) -> sp.csr_matrix:
    """The undirected simple kNN graph of ``X`` (CSR, float64 ones, sorted
    rows, no self loops): each point's ``n_neighbors`` nearest, itself
    included as cuML returns it, then symmetrized.  Above
    ``ann_threshold`` points the kNN is IVF-approximate."""
    n = X.shape[0]
    k = min(n_neighbors, n)
    if n > ann_threshold:
        logger.info(
            "phenograph kNN: %d points > %d, using IVF approximate search",
            n, ann_threshold,
        )
        with substage("phenograph.knn", items=n):
            idx = _ivf_knn(X, k, seed=seed)
    else:
        with substage("phenograph.knn", items=n):
            idx = exact_knn(X, k)

    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    A = sp.coo_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(n, n)
    ).tocsr()
    # undirected simple graph, no self loops
    A = ((A + A.T) > 0).astype(np.float64)
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    return A


def knn_jaccard_graph(
    X: np.ndarray, n_neighbors: int, ann_threshold: int = ANN_THRESHOLD,
    seed: int = 0,
) -> sp.csr_matrix:
    """Build the Jaccard-weighted undirected kNN graph.

    Matches cuGraph semantics: the kNN edge list (self included, as cuML
    returns the query point itself) is treated as an undirected simple
    graph (:func:`knn_adjacency`); Jaccard weight of edge (u, v) =
    |N(u) & N(v)| / |N(u) | N(v)| over graph neighborhoods.

    Above ``ann_threshold`` points the kNN is IVF-approximate (exact
    kNN is ~quadratic on CPU at PCA dimensionality; PhenoGraph's
    Jaccard + Louvain chain is robust to small neighbor perturbations —
    recall and end-to-end ARI pinned in the tests).
    """
    n = X.shape[0]
    A = knn_adjacency(X, n_neighbors, ann_threshold=ann_threshold,
                      seed=seed)

    # |N(u) & N(v)| for every existing edge by the native core's sorted
    # merge, O(E k) — never the whole (A @ A).multiply(A), which is tens
    # of GB at millions of cells
    with substage("phenograph.jaccard", items=A.nnz):
        Acoo = A.tocoo()
        inter = native.common_neighbor_counts(
            A.indptr, A.indices, Acoo.row, Acoo.col
        ).astype(np.float64)
        deg = np.asarray(A.sum(axis=1)).ravel()
        union = deg[Acoo.row] + deg[Acoo.col] - inter
        w = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        J = sp.coo_matrix((w, (Acoo.row, Acoo.col)), shape=(n, n)).tocsr()
        # keep zero-jaccard edges out; isolated nodes become singleton
        # clusters
        J.eliminate_zeros()
    return J


def common_neighbor_counts_spgemm(
    indptr: np.ndarray,
    indices: np.ndarray,
    eu: np.ndarray,
    ev: np.ndarray,
) -> np.ndarray:
    """The plain version of the native core's per-edge common-neighbor
    counts |N(u) & N(v)| of an undirected simple graph in CSR form
    (what :func:`knn_jaccard_graph` runs): the entries (u, v) of the
    two-hop product A @ A, taken in row blocks whose products hold about
    ``BLOCK_NNZ`` entries each, so memory stays bounded and a hub of the
    kNN graph costs its degree squared once.  (The JAX package's NumPy
    branch pads every row to the largest degree and compares an edge's
    two rows pairwise, E times the largest degree squared.)"""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    eu = np.ascontiguousarray(eu, dtype=np.int64)
    ev = np.ascontiguousarray(ev, dtype=np.int64)
    out = np.zeros(len(eu), dtype=np.int64)
    if len(eu) == 0:
        return out
    n = len(indptr) - 1
    A = sp.csr_matrix(
        (np.ones(len(indices), dtype=np.int64), indices, indptr),
        shape=(n, n),
    )
    # the entries each row's product row can have, at most, and the row
    # where each block ends
    ends = np.cumsum(A @ np.diff(indptr))
    order = np.argsort(eu, kind="stable")
    eu_s = eu[order]
    r0 = 0
    while r0 < n:
        done = ends[r0 - 1] if r0 else 0
        r1 = max(r0 + 1, int(np.searchsorted(ends, done + BLOCK_NNZ,
                                             side="right")))
        lo, hi = np.searchsorted(eu_s, [r0, r1])
        if hi > lo:
            sel = order[lo:hi]
            S = (A[r0:r1] @ A).tocsr()
            out[sel] = np.asarray(S[eu[sel] - r0, ev[sel]]).ravel()
        r0 = r1
    return out


def louvain(
    adj: sp.csr_matrix,
    resolution: float = 1.0,
    seed: int = 0,
    max_levels: int = 10,
    max_sweeps: int = 20,
) -> np.ndarray:
    """Louvain community detection on a weighted undirected graph.

    Vectorized local-moving implementation: each sweep proposes, for every
    node, the neighboring community with maximal modularity gain (computed
    via one sparse matmul onto the community-indicator matrix), applied
    with a deterministic tie-break.  Aggregates and recurses like the
    standard algorithm (cuGraph louvain analogue).
    """
    rng = np.random.default_rng(seed)
    n0 = adj.shape[0]
    # labels: original node -> current super-node of A
    labels = np.arange(n0)
    A = ((adj + adj.T) * 0.5).tocsr()

    for _level in range(max_levels):
        n = A.shape[0]
        m2 = A.sum()  # = 2m for undirected (each edge counted twice)
        if m2 <= 0 or n <= 1:
            break
        k = np.asarray(A.sum(axis=1)).ravel()  # weighted degrees
        comm = np.arange(n)
        improved = False
        Acoo = A.tocoo()
        eu, ev, ew = Acoo.row, Acoo.col, Acoo.data

        for _sweep in range(max_sweeps):
            # Edge-wise sweep, O(E log E): aggregate edge weights per
            # (node, neighbor-community) pair, then take the per-node
            # max modularity gain.  (The earlier dense (n, C) formulation
            # is O(n^2) in the first level where every node is its own
            # community.)
            C = int(comm.max()) + 1
            c_of_v = comm[ev]
            key = eu.astype(np.int64) * C + c_of_v
            uniq, inv = np.unique(key, return_inverse=True)
            Wuc = np.bincount(inv, weights=ew)
            uu = (uniq // C).astype(np.int64)
            cc = (uniq % C).astype(np.int64)
            sigma = np.bincount(comm, weights=k, minlength=C)
            own = cc == comm[uu]
            sig_eff = sigma[cc] - np.where(own, k[uu], 0.0)
            # insertion gain of u into c, with u removed from its own
            # community first (sig_eff excludes u there)
            gain = Wuc - resolution * k[uu] * sig_eff / m2
            # gain of RE-INSERTING into the own community (the baseline
            # a move must beat — comparing against 0 moves nodes out of
            # communities they are tightly bound to).  W(u, own\{u})
            # defaults to 0 for nodes with no intra-community edge and
            # excludes the self-loop, which stays with u either way.
            w_own = np.zeros(n)
            w_own[uu[own]] = Wuc[own]
            w_own = w_own - A.diagonal()
            own_gain = (
                w_own - resolution * k * (sigma[comm] - k) / m2
            )
            gain = gain - own_gain[uu]
            gain = np.where(own, 0.0, gain)
            # per-u argmax over its candidate communities
            order = np.lexsort((-gain, uu))
            uu_s = uu[order]
            first = np.concatenate([[True], uu_s[1:] != uu_s[:-1]])
            best_u = uu_s[first]
            best_c = cc[order][first]
            best_gain = gain[order][first]

            best = comm.copy()
            gain_best = np.zeros(n)
            best[best_u] = best_c
            gain_best[best_u] = best_gain

            move = (gain_best > 1e-12) & (best != comm)
            if not move.any():
                break
            # apply a random subset of moves to avoid oscillation
            apply = move & (rng.uniform(size=n) < 0.7)
            if not apply.any():
                apply = move
            comm = comm.copy()
            comm[apply] = best[apply]
            improved = True

        if not improved:
            break
        # compact community ids and compose original-node mapping
        _, comm = np.unique(comm, return_inverse=True)
        labels = comm[labels]
        C = comm.max() + 1
        if C == n:
            break
        # aggregate graph onto communities
        ind = sp.coo_matrix(
            (np.ones(n), (np.arange(n), comm)), shape=(n, C)
        ).tocsr()
        A = (ind.T @ A @ ind).tocsr()

    _, labels = np.unique(labels, return_inverse=True)
    return labels


def phenograph(
    X: np.ndarray,
    n_neighbors: int,
    resolution: float = 1.0,
    min_size: int = -1,
    seed: int = 0,
    ann_threshold: int = ANN_THRESHOLD,
) -> np.ndarray:
    """kNN -> Jaccard -> Louvain; clusters sorted by size descending and
    relabeled 0..C-1; clusters with size <= min_size get label -1
    (reference: neighbors.py:44-51).

    ``ann_threshold``: point count above which the kNN stage switches to
    the IVF approximate search (pass ``np.inf``-like large values to
    force exact).  The float64-upcast decision follows the same value so
    the exact path keeps its historical-parity dtype.
    """
    X = np.asarray(X)
    # exact path computes in float64 (historical parity); the ANN path
    # works in float32 internally, so skip the 8-byte upcast there
    if X.shape[0] <= ann_threshold:
        X = X.astype(np.float64)
    J = knn_jaccard_graph(X, n_neighbors, ann_threshold=ann_threshold,
                          seed=seed)
    with substage("phenograph.louvain", items=J.shape[0]):
        labels = louvain(J, resolution=resolution, seed=seed)
    # sort clusters by size (desc), relabel, drop small ones
    uniq, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    remap = np.full(uniq.max() + 1, -1, dtype=np.int64)
    for new_id, oi in enumerate(order):
        remap[uniq[oi]] = new_id if counts[oi] > min_size else -1
    return remap[labels]
