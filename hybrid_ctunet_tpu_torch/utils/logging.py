"""Scalar logging and running averages. Port of
``hybrid_ctunet_tpu/utils/logging.py``: the reference's tensorboardX
SummaryWriter (trainer_CTUNet.py:331-335, 358-359, 378-381) with its tag
names — ``train_loss``, ``val_acc`` (single-branch trainers),
``val_acc_hybrid`` / ``val_acc_res`` / ``val_acc_vit`` (CTUNet).

Every scalar goes to ``scalars.jsonl`` in the log directory; TensorBoard
event files are written too when ``tensorboardX`` is importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


def _tb_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir=logdir)


class ScalarWriter:
    """``add_scalar``-compatible writer: JSON lines, plus TensorBoard events
    where a writer is importable; a ``None`` logdir writes nothing."""

    def __init__(self, logdir: Optional[str]):
        self.enabled = logdir is not None
        self._tb = None
        self._f = None
        if self.enabled:
            os.makedirs(logdir, exist_ok=True)
            self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
            self._tb = _tb_writer(logdir)

    def add_scalar(self, tag: str, value, step: int):
        if not self.enabled:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class AverageMeter:
    """Running average (reference utils/utils.py:25-38)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count > 0 else self.sum
