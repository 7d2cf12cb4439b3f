"""The port's evaluation metrics (deeplearning4j_tpu_torch/eval/) against
the JAX package's on the same numpy labels and predictions, made from a
seed: the confusion matrix, every classification statistic (top-N and
time series with a mask included), merging, the stats text, and the
regression statistics. Both are host-side numpy of the same arithmetic:
every value must be equal (the regression sums to 1e-12 relative)."""

import numpy as np
import pytest

from deeplearning4j_tpu.eval import confusion as jconf
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu.eval import regression as jreg
from deeplearning4j_tpu_torch.eval import (
    ConfusionMatrix,
    Evaluation,
    RegressionEvaluation,
)

pytestmark = pytest.mark.port


def _classes(seed, shape, C, skip=()):
    """One-hot labels and probability rows over C classes; classes in
    `skip` never occur as labels (and so are never predicted right)."""
    rng = np.random.default_rng(seed)
    allowed = [c for c in range(C) if c not in skip]
    idx = rng.choice(allowed, size=shape)
    labels = np.eye(C, dtype=np.float32)[idx]
    logits = rng.standard_normal(shape + (C,)) + 2.0 * labels
    preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return labels, preds.astype(np.float32)


def _stats(ev, C):
    return dict(
        accuracy=ev.accuracy(), top_n=ev.top_n_accuracy(),
        precision=ev.precision(), recall=ev.recall(), f1=ev.f1(),
        per_class=[(ev.precision(c), ev.recall(c), ev.f1(c),
                    ev.false_positive_rate(c), ev.false_negative_rate(c))
                   for c in range(C)],
        tp=ev.true_positives(), examples=ev.examples,
        matrix=ev.confusion.matrix.tolist(), text=ev.stats())


@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("C,skip", [(10, ()), (5, (2,))],
                         ids=["10-classes", "never-predicted"])
def test_evaluation_equals_jax(C, skip, top_n):
    """Two batches of [B, C] rows: the same confusion matrix and the same
    accuracy, top-N accuracy, macro precision / recall / F1 (a class
    never predicted left out, with the warning in the stats text),
    per-class rates and stats text."""
    t, j = Evaluation(top_n=top_n), jev.Evaluation(top_n=top_n)
    for seed in (1, 2):
        labels, preds = _classes(seed, (40,), C, skip)
        t.eval(labels, preds)
        j.eval(labels, preds)
    assert _stats(t, C) == _stats(j, C)


def test_time_series_evaluation_with_mask_equals_jax():
    """[B, T, C] rows with a [B, T] mask (reference evalTimeSeries)."""
    labels, preds = _classes(3, (6, 7), 4)
    mask = (np.random.default_rng(4).random((6, 7)) > 0.3).astype(
        np.float32)
    t, j = Evaluation(), jev.Evaluation()
    t.eval(labels, preds, mask=mask)
    j.eval(labels, preds, mask=mask)
    assert _stats(t, 4) == _stats(j, 4)
    assert t.examples == int(mask.sum())


def test_merge_equals_jax():
    parts_t = [Evaluation(n_classes=6, top_n=2) for _ in range(3)]
    parts_j = [jev.Evaluation(n_classes=6, top_n=2) for _ in range(3)]
    for i, (pt, pj) in enumerate(zip(parts_t, parts_j)):
        labels, preds = _classes(10 + i, (20,), 6)
        pt.eval(labels, preds)
        pj.eval(labels, preds)
    t, j = parts_t[0], parts_j[0]
    for pt, pj in zip(parts_t[1:], parts_j[1:]):
        t.merge(pt)
        j.merge(pj)
    assert _stats(t, 6) == _stats(j, 6)
    other = Evaluation(top_n=3)
    other.eval(*_classes(20, (5,), 6))
    with pytest.raises(ValueError, match="top_n"):
        t.merge(other)


def test_confusion_matrix_equals_jax():
    t, j = ConfusionMatrix(["a", "b", "c"]), jconf.ConfusionMatrix(
        ["a", "b", "c"])
    for actual, pred, n in ((0, 0, 3), (0, 2, 1), (1, 1, 2), (2, 0, 4)):
        t.add(actual, pred, n)
        j.add(actual, pred, n)
    other_t, other_j = ConfusionMatrix(range(3)), jconf.ConfusionMatrix(
        range(3))
    other_t.add(1, 2)
    other_j.add(1, 2)
    t.add_matrix(other_t)
    j.add_matrix(other_j)
    assert t.to_csv() == j.to_csv() == str(t)
    for a in range(3):
        assert t.get_actual_total(a) == j.get_actual_total(a)
        assert t.get_predicted_total(a) == j.get_predicted_total(a)
        for p in range(3):
            assert t.get_count(a, p) == j.get_count(a, p)


@pytest.mark.parametrize("shape", [(30, 3), (4, 5, 2)],
                         ids=["2d", "time-series"])
def test_regression_evaluation_equals_jax(shape):
    """MSE, MAE, RMSE and R² per column and the stats text, over two
    batches (the time-series case with a mask)."""
    rng = np.random.default_rng(5)
    t, j = RegressionEvaluation(column_names=None), \
        jreg.RegressionEvaluation()
    for _ in range(2):
        labels = rng.standard_normal(shape)
        preds = labels + 0.3 * rng.standard_normal(shape)
        mask = None
        if len(shape) == 3:
            mask = (rng.random(shape[:2]) > 0.25).astype(np.float32)
        t.eval(labels, preds, mask=mask)
        j.eval(labels, preds, mask=mask)
    for c in range(shape[-1]):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "r_squared"):
            np.testing.assert_allclose(getattr(t, name)(c),
                                       getattr(j, name)(c), rtol=1e-12)
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.stats() == j.stats()
