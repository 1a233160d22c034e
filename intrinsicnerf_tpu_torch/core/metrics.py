"""Evaluation metrics: the segmentation mIoU suite and the depth metrics.

The port's numpy copy of ``intrinsicnerf_tpu/core/metrics.py``: a
confusion matrix over valid (non-ignore) pixels; per-class IoU; miou =
nanmean over all classes, miou_valid over the classes present in the GT;
total and class-average accuracy; depth AbsRel / AbsDiff / SqRel / RMSE /
LogRMSE / delta < 1.25^k / completeness with the (0, 10 m) validity mask.
Host side, at the eval cadence only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(true_labels, pred_labels, num_classes: int) -> np.ndarray:
    idx = true_labels.astype(np.int64) * num_classes + pred_labels.astype(np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def calculate_segmentation_metrics(
    true_labels: np.ndarray,
    predicted_labels: np.ndarray,
    number_classes: int,
    ignore_label: int = -1,
):
    """Returns (miou, miou_valid_class, total_accuracy,
    class_average_accuracy, ious)."""
    true_labels = np.asarray(true_labels).reshape(-1)
    predicted_labels = np.asarray(predicted_labels).reshape(-1)
    if np.all(true_labels == ignore_label):
        return 0.0, 0.0, 0.0, 0.0, np.zeros(number_classes)
    valid = true_labels != ignore_label
    t, p = true_labels[valid], predicted_labels[valid]

    conf = confusion_matrix(t, p, number_classes).astype(np.float64)
    row_sum = conf.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm_conf = conf / row_sum[:, None]  # rows: recall per class
        existing = row_sum > 0

        diag = np.diagonal(conf)
        class_avg_acc = np.nanmean(np.diagonal(norm_conf))
        total_acc = diag.sum() / conf.sum()
        union = conf.sum(axis=1) + conf.sum(axis=0) - diag
        ious = diag / union
    miou = np.nanmean(ious)
    miou_valid = np.mean(ious[existing]) if existing.any() else 0.0
    return (
        float(miou),
        float(miou_valid),
        float(total_acc),
        float(class_avg_acc),
        ious,
    )


def calculate_depth_metrics(
    depth_trgt: np.ndarray, depth_pred: np.ndarray
) -> Dict[str, float]:
    """2D depth metrics between GT and prediction (meters)."""
    depth_pred = np.asarray(depth_pred)
    depth_trgt = np.asarray(depth_trgt)
    mask1 = depth_pred > 0
    mask = (depth_trgt < 10) * (depth_trgt > 0) * mask1

    p, t = depth_pred[mask], depth_trgt[mask]
    abs_diff = np.abs(p - t)
    abs_rel = abs_diff / t
    sq_diff = abs_diff**2
    sq_rel = sq_diff / t
    sq_log_diff = (np.log(p) - np.log(t)) ** 2
    thresh = np.maximum(t / p, p / t)

    return {
        "AbsRel": float(np.mean(abs_rel)),
        "AbsDiff": float(np.mean(abs_diff)),
        "SqRel": float(np.mean(sq_rel)),
        "RMSE": float(np.sqrt(np.mean(sq_diff))),
        "LogRMSE": float(np.sqrt(np.mean(sq_log_diff))),
        "r1": float(np.mean((thresh < 1.25).astype(np.float64))),
        "r2": float(np.mean((thresh < 1.25**2).astype(np.float64))),
        "r3": float(np.mean((thresh < 1.25**3).astype(np.float64))),
        "complete": float(np.mean(mask1.astype(np.float64))),
    }


def psnr_np(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img_pred) - np.asarray(img_gt)) ** 2))
    if mse == 0:
        return float("inf")
    return float(-10.0 * np.log10(mse))
