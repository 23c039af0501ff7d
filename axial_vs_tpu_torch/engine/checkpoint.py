"""Checkpoints: step-numbered ``torch.save`` files with retention, resume
from the latest step, and a SIGTERM preemption flag (counterpart of
``axial_vs_tpu/engine/checkpoint.py``).

A checkpoint is one file, ``step_<8 digits>.pt``, holding whatever dict the
caller passes (the trainer's: the step, the model's ``state_dict`` with its
BatchNorm statistics, the optimizer's and the scheduler's, and the step
generator's state). It is written to a temporary file and renamed, so a
preempted save leaves no half file; the oldest files beyond ``max_to_keep``
are removed. Restores load on the CPU with ``weights_only``.
"""
from __future__ import annotations

import os
import re
import signal

import torch

_NAME = re.compile(r"step_(\d{8})\.pt")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._preempted = False
        self._old_handler = None

    # -- preemption ------------------------------------------------------
    def install_preemption_hook(self):
        """SIGTERM sets ``preempted`` instead of ending the process (the
        caller saves and stops); ``remove_preemption_hook`` restores the
        handler that was there. A no-op outside the main thread."""
        def handler(signum, frame):
            self._preempted = True

        try:
            self._old_handler = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            self._old_handler = None

    def remove_preemption_hook(self):
        if self._old_handler is not None:
            signal.signal(signal.SIGTERM, self._old_handler)
            self._old_handler = None

    @property
    def preempted(self) -> bool:
        return self._preempted

    # -- files -----------------------------------------------------------
    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.fullmatch(f)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict):
        """Write ``state`` as step ``step`` (replacing a file of that
        step)."""
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def restore(self):
        """The state saved at the latest step, or None when there is no
        checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
