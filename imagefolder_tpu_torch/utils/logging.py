"""Logging (counterpart of ``imagefolder_tpu/utils/logging.py``; reference
print-hijack and file tee ``utils/misc.py:40-112``, TensorboardLogger
``utils/misc.py:127-180``, wandb in ``vq_loss.py:150``).

Text logging on the primary process, a smoothed meter with an ETA, optional
wandb and tensorboard sinks (soft imports: a run without them logs text
only), and a ``torch.profiler`` trace window.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.parallel.dist import is_primary

__all__ = ["create_logger", "MetricMeter", "MetricLogger", "Tracker", "flatten_metrics",
           "profile_trace"]


def flatten_metrics(metrics: dict) -> dict:
    """Host floats of a metrics dict of tensors (on any device) or numbers,
    read back in one copy; an array-valued entry (the (P, S) per-scale
    codebook usage) expands into indexed scalars ``key/i_j``."""
    tensors = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
    host = {}
    if tensors:
        flat = torch.cat([v.detach().float().reshape(-1) for v in tensors.values()]).cpu()
        at = 0
        for k, v in tensors.items():
            host[k] = flat[at:at + v.numel()].numpy().reshape(v.shape)
            at += v.numel()
    out = {}
    for k, v in metrics.items():
        a = host[k] if k in host else np.asarray(v)
        if a.ndim == 0:
            out[k] = float(a)
        else:
            for idx in np.ndindex(a.shape):
                out[f"{k}/" + "_".join(map(str, idx))] = float(a[idx])
    return out


def create_logger(log_dir: Optional[str] = None, name: str = "imagefolder_tpu_torch"):
    """Primary-process file and stream logger (reference
    utils/logger.py:32-46); the other processes log nothing. A later call
    with another ``log_dir`` (a second CLI run in the same process) moves
    the file handler to that directory's ``log.txt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not is_primary():
        if not logger.handlers:
            logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir:
        path = (Path(log_dir) / "log.txt").absolute()
        for h in files:
            if Path(h.baseFilename) != path:
                logger.removeHandler(h)
                h.close()
        if not any(Path(h.baseFilename) == path for h in files):
            path.parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricMeter:
    """SmoothedValue (reference utils/misc.py:183-220)."""

    def __init__(self, window: int = 30):
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        v = float(value)
        self.window.append(v)
        self.total += v * n
        self.count += n

    @property
    def avg(self):
        return sum(self.window) / max(len(self.window), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    """Iteration logger with an ETA (reference utils/misc.py:285-337)."""

    def __init__(self, logger=None, log_every: int = 100):
        self.meters = defaultdict(MetricMeter)
        self.logger = logger or create_logger()
        self.log_every = log_every
        self._t0 = time.time()
        self._step0 = 0

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def log(self, step: int, total_steps: Optional[int] = None, prefix: str = ""):
        if step % self.log_every:
            return
        dt = time.time() - self._t0
        sps = (step - self._step0) / dt if dt > 0 else 0.0
        self._t0, self._step0 = time.time(), step
        msg = " ".join(f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items()))
        eta = ""
        if total_steps and sps > 0:
            eta = f" eta: {(total_steps - step) / sps / 3600:.1f}h"
        self.logger.info(f"{prefix}step {step} ({sps:.2f} it/s){eta} | {msg}")


class Tracker:
    """Optional wandb and tensorboard sinks; no-ops where a package is
    missing or on a process other than the primary."""

    def __init__(self, project: str = "imagefolder_tpu_torch", log_dir=None,
                 use_wandb: bool = False, use_tb: bool = False, config=None):
        self.wandb = None
        self.tb = None
        if not is_primary():
            return
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project=project, config=config)
            except Exception:
                self.wandb = None
        if use_tb and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except Exception:
                self.tb = None

    def log(self, metrics: dict, step: int):
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def log_image(self, tag: str, img_uint8_hwc, step: int):
        """An image grid (reference wandb.Image recon grids
        xqgan_train.py:513, TensorboardLogger.log_image utils/misc.py:162-166)."""
        if self.wandb is not None:
            import wandb

            self.wandb.log({tag: [wandb.Image(img_uint8_hwc)]}, step=step)
        if self.tb is not None:
            self.tb.add_image(tag, img_uint8_hwc, step, dataformats="HWC")

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` window over the CPU and, where there is one, the
    card; on exit its Chrome trace goes to ``log_dir/trace.json`` (primary
    process only)."""
    if not enabled or not is_primary():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
