"""DiceCE loss, MONAI's ``DiceCELoss(to_onehot_y=True, softmax=True,
squared_pred=True, smooth_nr=0.0, smooth_dr=1e-6)`` as the reference
configures it (main_CTUNet.py:156-158). Port of
``hybrid_ctunet_tpu/ops/losses.py``.

  dice  = mean over (batch, class incl. background) of
          1 - (2 sum(y p) + smooth_nr) / (sum(y^2) + sum(p^2) + smooth_dr),
          p = softmax(logits), y = onehot(labels), sums over space;
  ce    = softmax cross-entropy against the integer labels, voxel mean;
  total = dice + ce.

Channels-last: logits (B, X, Y, Z, C); labels (B, X, Y, Z) or
(B, X, Y, Z, 1). Every reduction runs in fp32, whatever the logits' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _prep_labels(labels: torch.Tensor) -> torch.Tensor:
    if labels.ndim == 5 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return labels.long()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, smooth_nr: float = 0.0,
              smooth_dr: float = 1e-6, squared_pred: bool = True) -> torch.Tensor:
    labels = _prep_labels(labels)
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels, logits.shape[-1]).float()
    spatial = tuple(range(1, logits.ndim - 1))
    intersection = (onehot * probs).sum(dim=spatial)
    if squared_pred:
        ground = onehot.square().sum(dim=spatial)
        pred = probs.square().sum(dim=spatial)
    else:
        ground = onehot.sum(dim=spatial)
        pred = probs.sum(dim=spatial)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (ground + pred + smooth_dr)
    return f.mean()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = _prep_labels(labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, smooth_nr: float = 0.0,
                 smooth_dr: float = 1e-6, squared_pred: bool = True) -> torch.Tensor:
    return dice_loss(logits, labels, smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                     squared_pred=squared_pred) + softmax_cross_entropy(logits, labels)
