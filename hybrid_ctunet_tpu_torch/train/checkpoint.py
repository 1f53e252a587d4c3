"""Checkpoints in the reference's format. Port of
``hybrid_ctunet_tpu/train/checkpoint.py``.

The reference saves ``{"epoch", "best_acc", "state_dict", "optimizer",
"scheduler"}`` with ``torch.save`` (trainer_CTUNet.py:308-317). The port
writes the same dict less the scheduler (the LR is a function of the epoch);
its ``state_dict`` carries the reference's keys, so the reference's code and
the JAX package (``hybrid_ctunet_tpu/train/checkpoint.py::
load_params_from_torch``) read it. The loader also reads the reference's own
``.pt`` files, whose keys may carry a ``backbone.`` prefix
(main_CTUNet.py:172).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str, filename: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, *, epoch: int, best_acc: float) -> str:
    """``torch.save`` of the reference's dict to ``directory/filename``
    (written to a temporary name, then renamed)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, filename))
    payload = {
        "epoch": int(epoch),
        "best_acc": float(best_acc),
        "state_dict": _to_cpu(model.state_dict()),
        "optimizer": _to_cpu(optimizer.state_dict()),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict of a ``.pt`` file on the CPU; a bare state dict comes back as
    ``{"state_dict": ...}``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(obj, dict) and "state_dict" in obj):
        obj = {"state_dict": obj}
    obj["state_dict"] = {k.replace("backbone.", ""): v for k, v in obj["state_dict"].items()}
    return obj


def load_weights(model: torch.nn.Module, path: str) -> Dict[str, Any]:
    """Load a ``.pt`` file's weights into ``model``; returns the file's dict.
    Every parameter of the model must be in the file; keys the model lacks
    (the reference's dead ResBlock ``conv3``, ROADMAP C2) are skipped."""
    ckpt = load_checkpoint(path)
    missing, unexpected = model.load_state_dict(ckpt["state_dict"], strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} parameters, e.g. {missing[:3]}")
    if unexpected:
        print(f"=> {path}: skipped {len(unexpected)} keys the model does not have")
    return ckpt
