"""Observability: scalars, histograms and images for TensorBoard, a CSV
of every scalar, and the profiler hooks.

Port of ``intrinsicnerf_tpu/train/logging_utils.py`` (``TBLogger``,
``NullLogger`` and the profiler hooks).  Every scalar is
written to ``<log_dir>/scalars.csv`` as ``step,name,value`` rows (what
``tools_convergence_gate.py:read_test_metrics`` and the port's gate twin
read), and to TensorBoard where ``torch.utils.tensorboard`` imports.
The profiler hooks trace with ``torch.profiler`` into
``<save_dir>/profile`` (a Chrome trace, viewable in Perfetto) in place
of ``jax.profiler``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np


def _ends_with_newline(path: str) -> bool:
    with open(path, "rb") as f:
        f.seek(-1, os.SEEK_END)
        return f.read(1) == b"\n"


class TBLogger:
    def __init__(self, log_dir: str, config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        path = os.path.join(log_dir, "scalars.csv")
        self._csv_file = open(path, "a", newline="")
        if self._csv_file.tell() and not _ends_with_newline(path):
            self._csv_file.write("\n")  # a row a killed run cut off stays a row of its own
        self._csv = csv.writer(self._csv_file)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard not installed: the CSV alone
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)
            if config is not None:
                self.writer.add_text("config", str(config), 0)

    def scalars(self, step: int, values: Dict[str, float]):
        for name, v in values.items():
            v = float(v)
            self._csv.writerow([step, name, v])
            if self.writer is not None:
                self.writer.add_scalar(name, v, step)
        self._csv_file.flush()

    def histogram(self, step: int, name: str, values):
        if self.writer is None:
            return
        values = np.asarray(values).reshape(-1)
        values = values[np.isfinite(values)]  # a diverged run still logs
        if values.size:
            self.writer.add_histogram(name, values, step)

    def image(self, step: int, name: str, img, dataformats="HWC"):
        if self.writer is not None:
            self.writer.add_image(name, np.asarray(img), step, dataformats=dataformats)

    def close(self):
        self._csv_file.close()
        if self.writer is not None:
            self.writer.close()


class NullLogger:
    """The logger of a data-parallel run's other ranks: rank 0 owns the
    log files, and the rest log nothing (their training is the same)."""

    writer = None

    def scalars(self, step, values):
        pass

    def histogram(self, step, name, values):
        pass

    def image(self, step, name, img, dataformats="HWC"):
        pass

    def close(self):
        pass


class ProfilerTrace:
    """``torch.profiler`` over a window of training steps, written as a
    Chrome trace to ``<save_dir>/profile/trace.json``."""

    def __init__(self, save_dir: str):
        from torch.profiler import ProfilerActivity, profile

        import torch

        self.path = os.path.join(save_dir, "profile", "trace.json")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> str:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        return self.path
