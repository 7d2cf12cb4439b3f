"""The port's clustering package (deeplearning4j_tpu_torch/clustering/)
on the CPU against the JAX package's, on the same numpy data.

* The host trees (KDTree, VPTree, SpTree, QuadTree) and the cluster
  objects are copies: every query answers exactly as JAX's does (the
  same neighbours in the same order, the same range sets, the same
  Barnes-Hut sums to the bit).
* KMeans: the k-means++ and random seeding draw the same rows from
  numpy; the Lloyd steps run in torch (one distance product, argmin,
  index_add_) against JAX's jitted step on the same f32 points: centers
  within 1e-5 of their scale, each distortion within 4 f32 ulps of
  sum ||x||^2 (the distance product's ||x||^2 + ||c||^2 - 2 x.c loses
  that much to cancellation in either package, about 1e-3 here), the
  memberships equal (the blobs have no near-ties), the same iteration
  count; on well-separated blobs the clusters recover them.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as jc
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu_torch import clustering as tc
from deeplearning4j_tpu_torch.clustering import kmeans as tkm

pytestmark = pytest.mark.port

CENTER_TOL = 1e-5
DISTORTION_RTOL = 1e-5
F32_EPS = float(np.finfo(np.float32).eps)


def _distortion_atol(pts):
    """The rounding scale of a distortion from the distance product."""
    return 4 * F32_EPS * float((pts.astype(np.float64) ** 2).sum())


def _blobs(rng, k=3, per=40, dim=4, spread=0.15):
    centers = rng.normal(size=(k, dim)) * 5.0
    pts = np.concatenate(
        [c + rng.normal(scale=spread, size=(per, dim)) for c in centers])
    return pts.astype(np.float32), np.repeat(np.arange(k), per)


def _members(cs, n):
    pred = np.empty(n, dtype=int)
    for ci, cluster in enumerate(cs.clusters):
        for p in cluster.points:
            pred[int(p.id)] = ci
    return pred


# ----------------------------------------------------------------- KMeans

@pytest.mark.parametrize("k,init,spread,seed", [
    (3, "k-means++", 0.15, 1), (4, "k-means++", 1.5, 3),
    (5, "random", 1.0, 0), (1, "k-means++", 1.0, 2)],
    ids=["blobs3", "overlap4", "random5", "k1"])
def test_kmeans_equals_jax(k, init, spread, seed):
    rng = np.random.default_rng(seed)
    pts, _ = _blobs(rng, k=max(k, 3), per=50, dim=6, spread=spread)
    ours = tc.KMeansClustering(k, max_iterations=60, seed=seed, init=init,
                               device="cpu")
    theirs = jc.KMeansClustering(k, max_iterations=60, seed=seed, init=init)
    np.testing.assert_array_equal(ours._init_centers(pts),
                                  np.asarray(_jax_init_rows(theirs, pts)))
    cs_t, cs_j = ours.apply_to(pts), theirs.apply_to(pts)
    scale = float(np.abs(cs_j.centers).max())
    assert np.abs(cs_t.centers - cs_j.centers).max() <= CENTER_TOL * scale
    assert ours.iteration_count == theirs.iteration_count
    np.testing.assert_allclose(ours.distortion_history,
                               theirs.distortion_history,
                               rtol=DISTORTION_RTOL,
                               atol=_distortion_atol(pts))
    np.testing.assert_array_equal(_members(cs_t, len(pts)),
                                  _members(cs_j, len(pts)))
    np.testing.assert_array_equal(ours.assignments.numpy(),
                                  _members(cs_t, len(pts)))


def _jax_init_rows(km, pts):
    """The rows JAX's `_init_centers` picks (its centers are rows of
    pts)."""
    centers = np.asarray(km._init_centers(pts))
    return [int(np.flatnonzero((pts == c).all(1))[0]) for c in centers]


def test_lloyd_step_equals_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(300, 16)).astype(np.float32)
    centers = pts[[3, 50, 90, 200]] + 0.1
    centers[2] = 100.0  # an empty cluster keeps its center
    jn, ja, jd = (np.asarray(a) for a in jkm._lloyd_step(pts, centers, 4))
    tn, ta, td = tkm._lloyd_step(torch.from_numpy(pts),
                                 torch.from_numpy(centers), 4)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert np.abs(tn.numpy() - jn).max() <= CENTER_TOL * np.abs(jn).max()
    assert float(td) == pytest.approx(float(jd), rel=DISTORTION_RTOL,
                                      abs=_distortion_atol(pts))
    np.testing.assert_array_equal(tn.numpy()[2], centers[2])


def test_kmeans_recovers_blobs_and_takes_tensors_and_points():
    rng = np.random.default_rng(11)
    pts, labels = _blobs(rng)
    cs = tc.KMeansClustering(3, max_iterations=50, seed=1,
                             device="cpu").apply_to(torch.from_numpy(pts))
    pred = _members(cs, len(pts))
    for b in range(3):
        assert len(set(pred[labels == b])) == 1
    assert len({pred[labels == b][0] for b in range(3)}) == 3
    h = tc.KMeansClustering(3, seed=1, device="cpu")
    h.apply_to(tc.Point.to_points(pts))
    hist = h.distortion_history
    assert all(hist[i + 1] <= hist[i] * (1 + 1e-6)
               for i in range(len(hist) - 1))
    with pytest.raises(ValueError, match="unsupported distance"):
        tc.KMeansClustering.setup(2, distance_function="manhattan")
    assert tc.KMeansClustering.setup(2, device="cpu").device.type == "cpu"
    assert tc.KMeansClustering(2).device.type == "cuda"


def test_cluster_set_classification_equals_jax():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.normal(size=(10, 2)) + 5,
                          rng.normal(size=(10, 2)) - 5]).astype(np.float32)
    sets = [tc.KMeansClustering(2, seed=0, device="cpu").apply_to(pts),
            jc.KMeansClustering(2, seed=0).apply_to(pts)]
    probe = rng.normal(size=(6, 2)).astype(np.float32) * 4
    for cs_t, cs_j in [sets]:
        for q in probe:
            a = cs_t.classify_point(tc.Point(q), move=False)
            b = cs_j.classify_point(jc.Point(q), move=False)
            assert a.cluster.id == b.cluster.id
            assert a.distance == pytest.approx(b.distance, rel=1e-6)
        assert cs_t.inertia() == pytest.approx(cs_j.inertia(), rel=1e-5)


# ------------------------------------------------------------------ trees

def test_kdtree_equals_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3))
    trees = (tc.KDTree(3), jc.KDTree(3))
    for p in pts:
        for t in trees:
            t.insert(p)
    for t in trees:
        assert t.delete(pts[17])
    for q in rng.normal(size=(10, 3)):
        a, b = (t.knn(q, 6) for t in trees)
        assert [d for d, _ in a] == [d for d, _ in b]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
        (da, pa), (db, pb) = (t.nn(q) for t in trees)
        assert da == db and np.array_equal(pa, pb)
    lo, hi = np.array([-0.5, -0.5, -1.0]), np.array([0.5, 0.7, 1.0])
    got = [sorted(map(tuple, t.range(r))) for t, r in zip(
        trees, (tc.HyperRect(lo, hi), jc.HyperRect(lo, hi)))]
    assert got[0] == got[1] and got[0]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_vptree_equals_jax_and_brute_force(metric):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(400, 8))
    labels = [f"w{i}" for i in range(len(pts))]
    ours = tc.VPTree(pts, labels=labels, metric=metric, seed=0)
    theirs = jc.VPTree(pts, labels=labels, metric=metric, seed=0)
    for q in rng.normal(size=(12, 8)):
        a, b = ours.search(q, 9), theirs.search(q, 9)
        assert a == b
        assert ours.words_nearest(q, 4) == theirs.words_nearest(q, 4)
        if metric == "euclidean":
            want = np.argsort(np.linalg.norm(pts - q, axis=1))[:9].tolist()
            assert [i for _, i in a] == want


def test_sptree_equals_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    pts = np.vstack([rng.normal(size=(120, 2)), rng.normal(size=(1, 2))
                     .repeat(3, 0)])
    ours, theirs = tc.SpTree(pts), jc.SpTree(pts)
    assert ours.cum_size == theirs.cum_size
    assert ours.depth() == theirs.depth()
    np.testing.assert_array_equal(ours.center_of_mass, theirs.center_of_mass)
    for i in (0, 7, 121):
        for theta in (0.0, 0.5):
            fa, fb = np.zeros(2), np.zeros(2)
            assert ours.compute_non_edge_forces(i, theta, fa) == \
                theirs.compute_non_edge_forces(i, theta, fb)
            np.testing.assert_array_equal(fa, fb)
    rows = np.arange(0, len(pts) + 1) * 2
    rows = np.minimum(rows, 2 * len(pts) - 2)
    cols = rng.integers(0, len(pts), rows[-1])
    vals = rng.random(rows[-1])
    np.testing.assert_array_equal(ours.compute_edge_forces(rows, cols, vals),
                                  theirs.compute_edge_forces(rows, cols,
                                                             vals))


def test_quadtree_equals_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(64, 2))
    ours, theirs = tc.QuadTree(pts), jc.QuadTree(pts)
    assert ours.cum_size == theirs.cum_size == 64
    assert ours.is_leaf == theirs.is_leaf
    for a, b in ((ours.north_east, theirs.north_east),
                 (ours.south_west, theirs.south_west)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.cum_size == b.cum_size
            np.testing.assert_array_equal(a.center_of_mass, b.center_of_mass)
    with pytest.raises(ValueError):
        tc.QuadTree(rng.normal(size=(10, 3)))
