"""Device-resident ANN index: batched partition-then-refine lookup (JAX
counterpart deeplearning4j_tpu/embedding/ann.py).

Reproduces the reference's L6 nearest-neighbor contract (clustering/
vptree.py's `search(target, k) -> [(distance, index)]`, kdtree's exact
top-k) as one batched program: coarse centroid routing (score the P
centroids, keep the top `nprobe`), then exact top-k scoring inside the
probed partitions. Partitions are fixed-shape [P, cap] padded with -1
ids, results are [Q, k].

Build is spherical k-means (a few Lloyd iterations on the device) over
the corpus, then capacity-capped assignment with spill on the host: rows
that overflow their nearest partition fall to the next-nearest with
room. The initial centroids come from `np.random.default_rng(seed)` and
the host assignment is the JAX package's algorithm, so on data without
near-ties the partitions are the JAX package's. `calibrate_nprobe` walks
the nprobe ladder until a held-out sample reaches the recall floor.

The metric is cosine via normalized dot products. The JAX package
computes these contractions and its top-k with jnp outside any Pallas
kernel; here they are `torch.matmul` / `torch.einsum` and `torch.topk`.
PyTorch has no jit to count, so `trace_count` counts the first search of
each (Q, k, nprobe) shape key, as the serving engines count shapes.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.telemetry import get_default

_NEG_INF = -1e30


def _normalize(x, dim=-1):
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / n.clamp_min(1e-12)


def _kmeans_iter(centroids, vecs):
    """One Lloyd iteration over normalized vectors (spherical k-means:
    assign by max dot, recenter, renormalize). Returns (centroids,
    assign)."""
    scores = vecs @ centroids.T                                  # [N, P]
    assign = torch.argmax(scores, dim=1)                         # [N]
    p = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, assign, vecs)
    counts = torch.bincount(assign, minlength=p).to(vecs.dtype)[:, None]
    # empty partitions keep their old centroid
    new = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return _normalize(new), assign


def _as_tensor(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def brute_force_topk(vectors, queries, k: int, device=None):
    """Exact cosine top-k — the recall baseline: one normalized matmul
    over the FULL table plus top-k. Returns (ids [Q, k] int32, scores
    [Q, k]) on `device` (the vectors' device when they are a tensor,
    else CUDA unless named)."""
    dev = (vectors.device if torch.is_tensor(vectors) and device is None
           else resolve_device(device))
    normed = _normalize(_as_tensor(vectors, dev))
    q = _normalize(_as_tensor(queries, dev))
    scores, idx = torch.topk(q @ normed.T, k, dim=1)
    return idx.to(torch.int32), scores


class DeviceANNIndex:
    """Fixed-shape IVF (partition-then-refine) index over an [V, D]
    corpus. `trace_count` counts first sights of (Q, k, nprobe)."""

    def __init__(self, centroids, part_vecs, part_ids, *, recorder=None):
        self.centroids = centroids          # [P, D] normalized
        self.part_vecs = part_vecs          # [P, cap, D] normalized, 0-pad
        self.part_ids = part_ids            # [P, cap] int32, -1 pad
        self.n_partitions, self.capacity, self.dim = part_vecs.shape
        self.device = part_vecs.device
        self._recorder = recorder if recorder is not None else get_default()
        self._seen = set()
        self._mu = threading.Lock()

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, vectors, n_partitions: int = 64, *,
              iters: int = 5, slack: float = 1.5, seed: int = 0,
              recorder=None, device=None) -> "DeviceANNIndex":
        """K-means + capacity-capped assignment with next-nearest spill.
        `slack` scales partition capacity over the perfectly-balanced
        V / P rows so skewed clusters keep their members."""
        dev = resolve_device(device)
        vecs = _normalize(_as_tensor(vectors, dev))
        v, d = vecs.shape
        p = min(int(n_partitions), v)
        rng = np.random.default_rng(seed)
        init = vecs[torch.as_tensor(rng.choice(v, size=p, replace=False),
                                    device=dev)]
        centroids = _normalize(init)
        for _ in range(max(1, iters)):
            centroids, _ = _kmeans_iter(centroids, vecs)

        cap = min(v, int(np.ceil(v / p * slack)))
        # host-side assignment (build time, not the query path): order
        # candidates by centroid affinity, spill to the next-nearest
        # partition with room
        scores = (vecs @ centroids.T).cpu().numpy()          # [V, P]
        pref = np.argsort(-scores, axis=1)                    # [V, P]
        part_rows = [[] for _ in range(p)]
        for row in range(v):
            for c in pref[row]:
                if len(part_rows[c]) < cap:
                    part_rows[c].append(row)
                    break
        part_ids = np.full((p, cap), -1, np.int32)
        host_vecs = vecs.cpu().numpy()
        part_vecs = np.zeros((p, cap, d), np.float32)
        for c, rows in enumerate(part_rows):
            if rows:
                part_ids[c, :len(rows)] = rows
                part_vecs[c, :len(rows)] = host_vecs[rows]
        return cls(centroids, torch.from_numpy(part_vecs).to(dev),
                   torch.from_numpy(part_ids).to(dev), recorder=recorder)

    # ------------------------------------------------------------- query
    def _search(self, queries, q: int, k: int, nprobe: int):
        qn = _normalize(queries)
        coarse = qn @ self.centroids.T                         # [Q, P]
        probe = torch.topk(coarse, nprobe, dim=1).indices      # [Q, nprobe]
        cand_vecs = self.part_vecs[probe]          # [Q, nprobe, cap, D]
        cand_ids = self.part_ids[probe].reshape(q, -1)
        fine = torch.einsum("qd,qncd->qnc", qn, cand_vecs).reshape(q, -1)
        fine = torch.where(cand_ids >= 0, fine,
                           torch.full_like(fine, _NEG_INF))
        scores, pos = torch.topk(fine, k, dim=1)
        return torch.gather(cand_ids, 1, pos), scores

    def search(self, queries, k: int = 10, *, nprobe: int = 8):
        """Batched ANN lookup: queries [Q, D] -> (ids [Q, k] int32,
        cosine scores [Q, k]) on the index's device, nearest-first — the
        vptree `search` contract, batched and fixed-shape."""
        queries = _as_tensor(queries, self.device)
        q = int(queries.shape[0])
        nprobe = min(int(nprobe), self.n_partitions)
        key = (q, int(k), nprobe)
        with self._mu:
            self._seen.add(key)
        probed_bytes = q * nprobe * self.capacity * (self.dim * 4 + 4)
        with self._recorder.span("ann_probe", queries=q, k=int(k),
                                 nprobe=nprobe, bytes=int(probed_bytes)):
            return self._search(queries, q, int(k), nprobe)

    @property
    def trace_count(self) -> int:
        with self._mu:
            return len(self._seen)

    # -------------------------------------------------------- calibration
    def calibrate_nprobe(self, vectors, sample_queries, k: int = 10,
                         floor: float = 0.95,
                         ladder=(4, 8, 16, 32, 64)) -> tuple:
        """Walk the nprobe ladder until recall@k on `sample_queries`
        reaches `floor` vs exact brute force. Runs before warmup.
        Returns (nprobe, recall)."""
        exact_ids, _ = brute_force_topk(vectors, sample_queries, k,
                                        device=self.device)
        exact = exact_ids.cpu().numpy()
        best = (int(ladder[-1]), 0.0)
        for nprobe in ladder:
            if nprobe > self.n_partitions:
                break
            ids, _ = self.search(sample_queries, k, nprobe=nprobe)
            r = recall_at_k(ids.cpu().numpy(), exact)
            best = (int(nprobe), float(r))
            if r >= floor:
                break
        return best


def recall_at_k(ann_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean |ANN ∩ exact| / k over the query batch."""
    q, k = exact_ids.shape
    hits = 0
    for row in range(q):
        hits += len(set(ann_ids[row].tolist())
                    & set(exact_ids[row].tolist()))
    return hits / float(q * k)
