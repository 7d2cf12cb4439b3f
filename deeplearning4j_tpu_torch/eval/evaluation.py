"""Classification evaluation (JAX counterpart
deeplearning4j_tpu/eval/evaluation.py; reference eval/Evaluation.java: eval:111
argmax compare, evalTimeSeries:189-221 with masks, stats():294 —
accuracy/precision/recall/f1 + confusion matrix).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.confusion import ConfusionMatrix


class Evaluation:
    def __init__(self, n_classes: int | None = None, labels=None,
                 top_n: int = 1):
        self.label_names = labels
        self._n = n_classes
        self.confusion: ConfusionMatrix | None = None
        if n_classes:
            self.confusion = ConfusionMatrix(range(n_classes))
        self.examples = 0
        # top-N accuracy tracking (reference Evaluation(int topN) ctor:
        # an example counts as top-N correct when the true class is among
        # the N highest-probability predictions)
        self.top_n = max(1, int(top_n))
        self.top_n_correct = 0

    def _ensure(self, n):
        if self.confusion is None:
            self._n = n
            self.confusion = ConfusionMatrix(range(n))

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [batch, C] one-hot/probabilities, or
        [batch, time, C] time series (reference evalTimeSeries) with
        optional [batch, time] mask."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions, dtype=np.float32)
        if labels.ndim == 3:
            if mask is None:
                labels = labels.reshape(-1, labels.shape[-1])
                predictions = predictions.reshape(-1, predictions.shape[-1])
            else:
                m = np.asarray(mask).astype(bool).reshape(-1)
                labels = labels.reshape(-1, labels.shape[-1])[m]
                predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(axis=-1)
        pred = predictions.argmax(axis=-1)
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        self.examples += len(actual)
        if self.top_n > 1 and len(actual):
            k = min(self.top_n, predictions.shape[-1])
            top = np.argpartition(predictions, -k, axis=-1)[:, -k:]
            self.top_n_correct += int((top == actual[:, None]).any(axis=-1).sum())
        else:
            self.top_n_correct += int((pred == actual).sum())

    def merge(self, other: "Evaluation"):
        """Merge partial evaluations (reference Evaluation.merge — used by
        distributed eval reduce)."""
        if other.confusion is None:
            return self
        if other.top_n != self.top_n:
            raise ValueError(
                f"cannot merge Evaluation(top_n={other.top_n}) into "
                f"Evaluation(top_n={self.top_n}) — counts are incompatible")
        self._ensure(other.confusion.matrix.shape[0])
        self.confusion.add_matrix(other.confusion)
        self.examples += other.examples
        self.top_n_correct += other.top_n_correct
        return self

    # ----------------------------------------------------------- metrics
    def _tp(self, c):
        return self.confusion.get_count(c, c)

    def true_positives(self):
        return {c: self._tp(c) for c in range(self._n)}

    def accuracy(self) -> float:
        if self.examples == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.examples

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class is in the top-N predictions
        (reference Evaluation.topNAccuracy)."""
        if self.examples == 0:
            return 0.0
        return self.top_n_correct / self.examples

    def precision(self, c: int | None = None) -> float:
        if c is not None:
            denom = self.confusion.get_predicted_total(c)
            return self._tp(c) / denom if denom else 0.0
        # macro average over classes that were predicted at least once —
        # never-predicted classes are excluded, matching the warning stats()
        # prints (reference Evaluation.java:312-318)
        vals = [self.precision(i) for i in range(self._n)
                if self.confusion.get_predicted_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: int | None = None) -> float:
        if c is not None:
            denom = self.confusion.get_actual_total(c)
            return self._tp(c) / denom if denom else 0.0
        vals = [self.recall(i) for i in range(self._n)
                if self.confusion.get_actual_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: int | None = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, c: int) -> float:
        fp = self.confusion.get_predicted_total(c) - self._tp(c)
        neg = self.examples - self.confusion.get_actual_total(c)
        return fp / neg if neg else 0.0

    def false_negative_rate(self, c: int) -> float:
        fn = self.confusion.get_actual_total(c) - self._tp(c)
        pos = self.confusion.get_actual_total(c)
        return fn / pos if pos else 0.0

    def stats(self) -> str:
        """Summary string (reference stats():294, incl. the never-predicted
        class warnings :312-318)."""
        lines = ["==========================Scores=========================="]
        warnings = []
        for c in range(self._n or 0):
            if (self.confusion.get_predicted_total(c) == 0
                    and self.confusion.get_actual_total(c) > 0):
                warnings.append(
                    f"Warning: class {c} was never predicted by the model. "
                    f"This class was excluded from average precision")
        lines.extend(warnings)
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("===========================================================")
        if self.confusion is not None and (self._n or 0) <= 20:
            lines.append("Confusion matrix:")
            lines.append(self.confusion.to_csv())
        return "\n".join(lines)
