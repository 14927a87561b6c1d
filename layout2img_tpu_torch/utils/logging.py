"""The training run's logger and metric stream (counterpart of
``layout2img_tpu/utils/logging.py``): a logger writing to standard output and
to ``<out_dir>/log.txt``, and ``MetricWriter``, an append-only
``<out_dir>/metrics.jsonl`` plus PNG grids of images under
``<out_dir>/images/``. ``tensorboard=True`` mirrors both into tensorboardX
event files under ``<out_dir>/tb`` where that package is importable.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np


def setup_logger(name: str, save_dir: str | None = None, rank: int = 0) -> logging.Logger:
    """A logger that does not propagate, with a stdout handler and, given
    ``save_dir``, a ``log.txt`` handler there; rank > 0 gets no handlers.
    Handlers are added once per name."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if rank > 0 or logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Close and remove the handlers ``setup_logger`` added."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


class MetricWriter:
    """``metrics.jsonl`` lines ``{"step", "time", **metrics}`` and image grids."""

    def __init__(self, out_dir: str, rank: int = 0, tensorboard: bool = False):
        self.rank = rank
        self.out_dir = out_dir
        self._f = None
        self._tb = None
        if rank != 0:
            return
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logging.getLogger(__name__).warning(
                    "tensorboardX not installed; TB mirroring disabled")
            else:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def write(self, step: int, metrics: dict) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def write_images(self, step: int, name: str, images, nrow: int = 4) -> None:
        """images (n, 3, h, w) in [-1, 1] (a tensor or an array) ->
        ``images/{name}_{step:08d}.png``, ``nrow`` images a row."""
        if self.rank != 0:
            return
        import PIL.Image

        if hasattr(images, "detach"):
            images = images.detach().float().cpu().numpy()
        arr = np.clip(np.asarray(images, np.float32).transpose(0, 2, 3, 1) * 0.5 + 0.5, 0, 1)
        n, h, w, c = arr.shape
        rows = -(-n // nrow)
        grid = np.zeros((rows * h, nrow * w, c), arr.dtype)
        for i in range(n):
            r, col = divmod(i, nrow)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
        img_dir = os.path.join(self.out_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        PIL.Image.fromarray((grid * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{name}_{step:08d}.png"))
        if self._tb is not None:
            self._tb.add_image(name, grid.transpose(2, 0, 1), int(step))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
