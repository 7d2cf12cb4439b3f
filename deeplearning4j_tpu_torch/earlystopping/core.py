"""Early stopping — train-until-no-improvement protocol (JAX counterpart
deeplearning4j_tpu/earlystopping/core.py).

Reference: earlystopping/ — EarlyStoppingConfiguration (builder:
saver/termination/scoreCalculator/evalInterval),
trainer/BaseEarlyStoppingTrainer.java:82 (epoch loop: fit → score → check
terminations → save best), saver/{InMemoryModelSaver,LocalFileModelSaver},
scorecalc/DataSetLossCalculator, termination/* (MaxEpochs, MaxTime,
MaxScore, ScoreImprovement, BestScoreEpoch, InvalidScore).

`LocalFileModelSaver` writes `bestModel.zip` and `latestModel.zip`
(util/model_serializer.py, the JAX package's zip format); the best model
comes back as a new network of the saved configuration on the saving
net's device.
"""

from __future__ import annotations

import copy
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_tpu_torch.nn import tree


# ------------------------------------------------------------ score calcs
class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average network loss over a held-out iterator (reference
    scorecalc/DataSetLossCalculator.java — also covers the CG variant)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, count = 0.0, 0
        self.iterator.reset()
        while self.iterator.has_next():
            ds = self.iterator.next()
            total += net.score(ds) * ds.num_examples()
            count += ds.num_examples()
        if count == 0:
            return float("nan")
        return total / count if self.average else total


# ---------------------------------------------------------- terminations
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no score improvement (reference
    ScoreImprovementEpochTerminationCondition)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch, score):
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
        else:
            self.since += 1
        return self.since > self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    def __init__(self, best_expected_score: float):
        self.target = best_expected_score

    def terminate(self, epoch, score):
        return score < self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self.start = time.monotonic()

    def terminate(self, last_score):
        return (time.monotonic() - self.start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)


# ----------------------------------------------------------------- savers
class ModelSaver:
    def save_best_model(self, net, score):
        raise NotImplementedError

    def save_latest_model(self, net, score):
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    """Keeps a deep copy of params/state in memory (reference InMemoryModelSaver)."""

    def __init__(self):
        self.best = None
        self.latest = None

    @staticmethod
    def _snapshot(net):
        snap = copy.copy(net)
        snap.params = tree.clone(net.params)
        snap.state = tree.clone(net.state)
        return snap

    def save_best_model(self, net, score):
        self.best = self._snapshot(net)

    def save_latest_model(self, net, score):
        self.latest = self._snapshot(net)

    def get_best_model(self):
        return self.best


class LocalFileModelSaver(ModelSaver):
    """Writes bestModel.zip / latestModel.zip (reference
    LocalFileModelSaver; covers the graph's LocalFileGraphSaver too — one
    serializer handles both). The best model loads onto `device`, else
    the device of the net last saved, else CUDA."""

    def __init__(self, directory: Optional[str] = None, device=None):
        self.directory = directory or tempfile.mkdtemp(prefix="dl4j_tpu_es_")
        os.makedirs(self.directory, exist_ok=True)
        self._device = device

    def _save(self, net, name):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer,
        )

        self._device = self._device or net.device
        ModelSerializer.write_model(net, os.path.join(self.directory, name))

    def save_best_model(self, net, score):
        self._save(net, "bestModel.zip")

    def save_latest_model(self, net, score):
        self._save(net, "latestModel.zip")

    def get_best_model(self):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer,
        )

        return ModelSerializer.restore(
            os.path.join(self.directory, "bestModel.zip"),
            device=self._device)


# ------------------------------------------------------------ config/result
@dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator = None
    model_saver: ModelSaver = field(default_factory=InMemoryModelSaver)
    epoch_terminations: list = field(default_factory=list)
    iteration_terminations: list = field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object


class EarlyStoppingTrainer:
    """Epoch loop (reference trainer/BaseEarlyStoppingTrainer.java:82)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.it = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        best_score, best_epoch = math.inf, -1
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            self.it.reset()
            self.net.fit(self.it, epochs=1)
            # iteration-level terminations checked on the epoch's last score
            stop_iter = None
            for t in cfg.iteration_terminations:
                if t.terminate(self.net.score_value):
                    stop_iter = t
                    break
            if stop_iter is not None:
                reason = "IterationTermination"
                details = type(stop_iter).__name__
                break
            score = self.net.score_value
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = (cfg.score_calculator.calculate_score(self.net)
                         if cfg.score_calculator else self.net.score_value)
                scores[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, score)
            # epoch terminations run EVERY epoch (reference
            # BaseEarlyStoppingTrainer checks them independently of the
            # score-calculation interval), using the most recent score
            stop_epoch = None
            for t in cfg.epoch_terminations:
                if t.terminate(epoch, score):
                    stop_epoch = t
                    break
            if stop_epoch is not None:
                reason = "EpochTermination"
                details = type(stop_epoch).__name__
                epoch += 1
                break
            epoch += 1
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=scores,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch,
            best_model=cfg.model_saver.get_best_model(),
        )


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """Same loop for ComputationGraph (reference EarlyStoppingGraphTrainer)."""
