"""Pixel-space evaluation metrics.

The port's copy of bifold_tpu/metrics/__init__.py: the ``Metrics``
accumulator (:187) driving best-checkpoint logic, with ``KeypointMSE``
(:77), ``AveragePrecision`` at k px (:91), ``IoU`` of the mask head (:116)
and ``QuantileProb`` (:145, the empirical-CDF quantile of the heatmap value
at the GT pixel), over the port's :class:`~bifold_tpu_torch.env.action.Action`.

Metrics accumulate on the host over decoded actions, in numpy, with the
reference's accumulation quirks (KeypointMSE divides a sum of batch means
by a count of valid samples). Each metric turns a batch into sums and
counts (:meth:`BaseMetric.terms`) and those into the batch's value
(:meth:`BaseMetric.combine`); under data parallelism the Trainer sums the
terms over the ranks first (``Metrics(..., reduce=...)``), so a batch's
value is the global batch's, not an average of the ranks' values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bifold_tpu_torch.env.action import Action

__all__ = ["Metrics", "BaseMetric", "KeypointMSE", "AveragePrecision", "IoU",
           "QuantileProb"]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _valid_and_distance(target: np.ndarray, pred: np.ndarray):
    """Per-sample validity + min distance to the GT point set.

    The reference passes variable-length (B, k, 2) or (B, 2) targets and calls
    a sample valid when every coordinate is STRICTLY > 0
    (metrics/__init__.py:113,119,138,140) — a keypoint on pixel row/column 0
    invalidates the whole sample. Our fixed-schema samples pad point sets to
    (B, 8, 2) with -1 rows; padded rows are "absent" (the reference never
    sees them), so validity is: at least one real (non-padding) row AND
    every real row strictly positive. Distances minimize over the real rows
    of valid samples — identical semantics on unpadded data, including the
    border-0 exclusion quirk.
    """
    pred = _np(pred)
    target = _np(target)
    if target.ndim == 2:
        target = target[:, None, :]
    row_min = np.min(target, axis=-1)     # (B, K)
    row_real = row_min >= 0               # not a -1 padding row
    row_pos = row_min > 0                 # reference validity per row
    valid = row_real.any(axis=1) & (row_pos == row_real).all(axis=1)
    d = np.linalg.norm(target.round() - pred[:, None, :], axis=-1)  # (B, K)
    d = np.where(row_real, d, np.inf)
    distances = d.min(axis=1)[valid]
    return valid, distances


class BaseMetric:
    """Accumulates per-batch values; summary = mean; lower is better."""

    def __init__(self, *args, **kwargs):
        self.values: list = []

    def terms(self, action: Action, sample, **kwargs) -> Optional[list]:
        """The batch's sums and counts (None: the batch has no value)."""
        raise NotImplementedError

    def combine(self, terms) -> float:
        """The batch's value from its (possibly rank-summed) terms."""
        raise NotImplementedError

    def __call__(self, action: Action, sample, **kwargs):
        terms = self.terms(action, sample, **kwargs)
        if terms is not None:
            self.values.append(self.combine(terms))

    @staticmethod
    def is_better(old_value, new_value) -> bool:
        return old_value is None or new_value < old_value

    def reset(self):
        self.values = []

    def summary(self):
        return float(np.array(self.values).mean())


class KeypointMSE(BaseMetric):
    """Mean pixel distance of decoded actions to (the nearest of) the GT
    pixels; invalid (-1) targets excluded (metrics/__init__.py:106-126)."""

    def terms(self, action: Action, sample, **kwargs):
        # per field: the sum of its valid distances and their count
        out = []
        for k, pred in action.fields():
            _, batch_loss = _valid_and_distance(sample[k], pred)
            out += [batch_loss.sum(), batch_loss.size]
        return out

    def combine(self, terms):
        total_loss = 0.0
        n = 0
        for total, count in zip(terms[::2], terms[1::2]):
            total_loss += total / count if count else 0.0
            n += int(count)
        return total_loss / n if n != 0 else 0


class AveragePrecision(BaseMetric):
    """Fraction of predictions within ``threshold`` px of a GT pixel; invalid
    targets credit predicted-invalid (metrics/__init__.py:179-213)."""

    def __init__(self, threshold: float):
        super().__init__()
        self.threshold = threshold

    def terms(self, action: Action, sample, **kwargs):
        total_precision = 0
        n = 0
        for k, pred in action.fields():
            pred = _np(pred)
            valid, distances = _valid_and_distance(sample[k], pred)
            total_precision += int((distances < self.threshold).sum())
            if (~valid).any():
                total_precision += int((pred[~valid].min(axis=1) < 0).sum())
            n += len(pred)
        return [total_precision, n]

    def combine(self, terms):
        total_precision, n = terms
        return (total_precision / n) * 100 if n else 0.0

    @staticmethod
    def is_better(old_value, new_value) -> bool:
        return old_value is None or new_value > old_value


class IoU(BaseMetric):
    """Binary Jaccard index of the mask head at 0.5 vs the cloth mask, in %;
    NaN when the model has no mask head (metrics/__init__.py:76-103)."""

    def terms(self, action=None, sample=None, raw_output: Optional[Dict] = None,
              **kwargs):
        if raw_output is None or "mask_heatmap" not in raw_output:
            return None
        pred = _np(raw_output["mask_heatmap"]) > 0.5
        mask = _np(sample["mask"])
        if mask.ndim == 4:
            mask = mask[:, 0]
        target = mask > 0.5
        return [np.logical_and(pred, target).sum(), np.logical_or(pred, target).sum()]

    def combine(self, terms):
        intersection, union = terms
        # empty union -> 0, matching torchmetrics BinaryJaccardIndex
        # (_safe_divide of tp/(tp+fp+fn) = 0/0 returns 0, not 1): an
        # all-background prediction on an empty GT mask must not score 100
        iou = intersection / union if union > 0 else 0.0
        return 100.0 * iou

    def summary(self):
        return super().summary() if self.values else float(np.nan)

    @staticmethod
    def is_better(old_value, new_value) -> bool:
        return old_value is None or new_value > old_value


class QuantileProb(BaseMetric):
    """Empirical-CDF rank of the heatmap value at the GT pixel, in %.

    For a valid target, credit the fraction of heatmap pixels <= the value at
    the GT pixel (higher = the model concentrates mass at the target); for an
    invalid target, credit the complement (metrics/__init__.py:128-176).
    """

    def terms(self, action: Action, sample, raw_output: Optional[Dict] = None,
              **kwargs):
        assert raw_output is not None
        total_prob = 0.0
        n = 0
        for k, _ in action.fields():
            heatmaps = _np(raw_output[k + "_heatmap"])
            target = _np(sample[k])
            if target.ndim == 2:
                target = target[:, None, :]
            row_min = np.min(target, axis=-1)
            row_real = row_min >= 0          # not -1 padding
            # reference validity (metrics/__init__.py:138,140): every
            # coordinate strictly > 0; padded rows are "absent"
            valid = row_real.any(axis=1) & ((row_min > 0) == row_real).all(
                axis=1)
            for i, v in enumerate(valid):
                hm = heatmaps[i]
                rows = (target[i][row_real[i]] if row_real[i].any()
                        else target[i][:1])
                xs = np.round(rows[:, 0]).astype(int).clip(0, hm.shape[1] - 1)
                ys = np.round(rows[:, 1]).astype(int).clip(0, hm.shape[0] - 1)
                vals = hm[ys, xs]
                # rank of each GT-pixel value in the heatmap's empirical CDF
                probs = (hm.flatten()[None, :] <= vals[:, None]).mean(axis=1)
                total_prob += probs.mean() if v else 1.0 - probs.mean()
                n += 1
        return [total_prob, n]

    def combine(self, terms):
        total_prob, n = terms
        return (total_prob / n) * 100 if n else 0.0

    @staticmethod
    def is_better(old_value, new_value) -> bool:
        return old_value is None or new_value > old_value


class Metrics:
    """Named-metric accumulator; ``summary()`` reports values and whether the
    tracked metric improved (drives best-checkpointing,
    metrics/__init__.py:10-50)."""

    def __init__(self, cfg):
        self.best_eval = None
        self.tracked_metric = cfg["tracked_metric"]
        self.metrics = {name: self.get_by_name(name)
                        for name in cfg["computed_metrics"]}

    @staticmethod
    def get_by_name(metric_name: str) -> BaseMetric:
        if metric_name == "kp_mse":
            return KeypointMSE()
        if metric_name.startswith("ap_"):
            return AveragePrecision(int(metric_name.split("ap_")[-1]))
        if metric_name == "iou":
            return IoU()
        if metric_name == "quantile_prob":
            return QuantileProb()
        raise ValueError(f"Metric {metric_name} not recognized")

    def reset(self):
        for metric in self.metrics.values():
            metric.reset()

    def summary(self):
        has_improved = False
        metric_dict = {}
        for name, metric in self.metrics.items():
            value = metric.summary()
            metric_dict[name] = value
            if name == self.tracked_metric and metric.is_better(
                    old_value=self.best_eval, new_value=value):
                self.best_eval = value
                has_improved = True
        return has_improved, metric_dict

    def __call__(self, *args, reduce=None, **kwargs):
        """Add one batch to every metric; ``reduce`` (a list of numbers ->
        their sums over the ranks) makes each batch's value the global
        batch's: one call reduces every metric's terms together."""
        if reduce is None:
            for metric in self.metrics.values():
                metric(*args, **kwargs)
            return
        terms = {name: metric.terms(*args, **kwargs)
                 for name, metric in self.metrics.items()}
        present = [name for name, t in terms.items() if t is not None]
        summed = iter(reduce([x for name in present for x in terms[name]]))
        for name in present:
            metric = self.metrics[name]
            metric.values.append(metric.combine([next(summed) for _ in terms[name]]))
