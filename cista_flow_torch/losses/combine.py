"""Loss and metric aggregators and the dataset dispatchers of the
reference's flow pretraining.

Counterpart of cista_flow_tpu/losses/combine.py (ref:
DCEIFlow/core/loss/Combine.py:11-34, core/metric/Combine.py:11-53,
utils/datasets/__init__.py:4-52): a weighted sum of named loss callables, a
running metric accumulator with its summary, and the JAX package's
``fetch_dataset`` and ``fetch_test_dataset`` (combine.py:66-97), which pick
FlyingChairs2 and MVSEC sets by ``args.stage``.
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


def fetch_dataset(args, data_root_chairs2="./data/FlyingChairs2"):
    """The training set of ``args.stage`` 'chairs2' (ref:
    utils/datasets/__init__.py:4-21): FlyingChairs2's train split augmented
    (crops of ``args.image_dim``, flips), with its ``trainval`` split for
    validation. Returns (train, [val sets], [their names])."""
    from ..data.flying_chairs2 import FlyingChairs2

    if args.stage == "chairs2":
        aug_params = {"crop_size": tuple(args.image_dim), "min_scale": -0.2, "max_scale": 0.4,
                      "do_flip": True}
        train = FlyingChairs2(args, data_root_chairs2, data_kind="train", aug_params=aug_params)
        val = FlyingChairs2(args, data_root_chairs2, data_kind="trainval")
        return train, [val], ["chairs2trainval"]
    raise NotImplementedError(f"unknown stage {args.stage}")


def fetch_test_dataset(args, data_root_chairs2="./data/FlyingChairs2",
                       data_root_mvsec="./data/MVSEC_HDF5"):
    """The test sets of ``args.stage`` (ref: utils/datasets/__init__.py:24-52):
    'chairs2'/'chairs2val' FlyingChairs2's val split, 'chairs2train' its
    train split, 'mvsec'/'mvsecfull' the MVSEC voxel reader over
    indoor_flying1-3 and outdoor_day1-2. Returns ([sets], [names])."""
    from ..data.flying_chairs2 import FlyingChairs2
    from ..data.mvsec import MVSEC

    if args.stage in ("chairs2", "chairs2val"):
        return [FlyingChairs2(args, data_root_chairs2, data_kind="val")], ["chairs2val"]
    if args.stage == "chairs2train":
        return [FlyingChairs2(args, data_root_chairs2, data_kind="train")], ["chairs2train"]
    if args.stage in ("mvsec", "mvsecfull"):
        splits = ["indoor_flying1", "indoor_flying2", "indoor_flying3", "outdoor_day1",
                  "outdoor_day2"]
        return ([MVSEC(args, data_root_mvsec, data_split=s) for s in splits],
                [f"mvsecval/{s}" for s in splits])
    raise NotImplementedError(f"unknown stage {args.stage}")
