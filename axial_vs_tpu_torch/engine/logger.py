"""Logging: a stdout and file logger, and windowed metric smoothing with a
JSONL event stream (counterpart of ``axial_vs_tpu/engine/logger.py``; no
wandb)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import defaultdict, deque


def setup_logger(name="axial_vs_tpu_torch", output_dir=None, rank=0):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        f"[%(asctime)s rank{rank} %(name)s %(levelname)s] %(message)s",
        datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log.rank{rank}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Windowed smoothing of scalar metrics, a line to ``metrics.jsonl`` per
    logged step, and a smoothed summary to ``logger`` every ``log_every``
    steps."""

    def __init__(self, output_dir=None, window: int = 20, log_every: int = 20):
        self.window = window
        self.log_every = log_every
        self._hist = defaultdict(lambda: deque(maxlen=window))
        self._jsonl = None
        self._last = time.time()
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict, logger=None):
        scalars = {k: float(v) for k, v in metrics.items()}
        for k, v in scalars.items():
            self._hist[k].append(v)
        now = time.time()
        scalars["iter_time"] = now - self._last
        self._last = now
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": int(step), **scalars}) + "\n")
            self._jsonl.flush()
        if logger and step % self.log_every == 0:
            smooth = {k: sum(d) / len(d) for k, d in self._hist.items() if d}
            logger.info(f"iter {step}: " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(smooth.items())))

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
