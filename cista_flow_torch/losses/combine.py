"""Loss and metric aggregators of the reference's flow pretraining.

Counterpart of cista_flow_tpu/losses/combine.py (ref:
DCEIFlow/core/loss/Combine.py:11-34, core/metric/Combine.py:11-53): a
weighted sum of named loss callables, and a running metric accumulator with
its summary. The dataset dispatchers beside them there (``fetch_dataset``,
``fetch_test_dataset``) read FlyingChairs2 and MVSEC, which the repo does
not hold.
"""
from __future__ import annotations

from typing import Callable, Sequence


class CombineLoss:
    """The weighted sum of loss callables, each ``(output, target) ->
    (loss, metrics)``; returns their merged metrics with the sum as 'loss'."""

    def __init__(self, losses: Sequence[Callable], weights: Sequence[float]):
        if len(losses) != len(weights):
            raise ValueError(f"{len(losses)} losses but {len(weights)} weights")
        self.losses = list(losses)
        self.weights = list(weights)

    def __call__(self, output, target) -> dict:
        total, metrics = 0.0, {}
        for fn, w in zip(self.losses, self.weights):
            loss, m = fn(output, target)
            total = total + loss * w
            metrics.update(m)
        metrics["loss"] = total
        return metrics


class CombineMetric:
    """A running accumulator of metric callables (``calculate``, ``push``,
    ``summary``)."""

    def __init__(self, metrics: Sequence[Callable]):
        self.metrics = list(metrics)
        self.all_metrics: dict[str, list] = {}

    def clear(self) -> None:
        self.all_metrics = {}

    def calculate(self, output, target, name=None) -> dict:
        out = {}
        for fn in self.metrics:
            out.update(fn(output, target))
        return out

    def push(self, metric_each: dict) -> dict:
        for key, v in metric_each.items():
            self.all_metrics.setdefault(key, []).append(float(v))
        return self.all_metrics

    def get_all(self) -> dict:
        return self.all_metrics

    def summary(self):
        """(text, {metric: mean}) of what was pushed; then clears."""
        summary = {k: sum(v) / len(v) for k, v in self.all_metrics.items()}
        text = ",".join(f"{k}:{v:8.6f}" for k, v in summary.items())
        self.clear()
        return text, summary
