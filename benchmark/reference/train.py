"""The reference's CTUNet training step in plain float32: DiceCE losses with
deep supervision (trainer_CTUNet.py: the res heads' loss, plus half the
vit heads'), and AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled decay).

The four crops of a step run one at a time with their gradients summed,
each loss divided by four: the losses are means over the crops (Dice over
(crop, class), cross-entropy over the voxels of all crops alike), so the
sum is the batch's gradient, and a crop at a time fits the card in float32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def zoom_nearest(labels: torch.Tensor, zoom: Sequence[float]) -> torch.Tensor:
    """scipy ``ndimage.zoom(order=0)`` of (B, X, Y, Z) labels over the three
    spatial axes: out size ``round(n * z)``, out index i reads
    ``floor(i (n - 1) / (m - 1) + 0.5)``."""
    for axis, z in zip((1, 2, 3), zoom):
        n = labels.shape[axis]
        m = int(round(n * z))
        if m == n:
            continue
        idx = np.floor(np.arange(m) * (n - 1) / max(m - 1, 1) + 0.5).astype(np.int64)
        labels = labels.index_select(axis, torch.from_numpy(np.clip(idx, 0, n - 1))
                                     .to(labels.device))
    return labels


def dice_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MONAI DiceCELoss(to_onehot_y, softmax, squared_pred, smooth_nr 0,
    smooth_dr 1e-6): 1 - 2 sum(y p) / (sum y^2 + sum p^2 + 1e-6) averaged
    over (crop, class), plus the voxel mean of the cross-entropy."""
    probs = torch.softmax(logits, -1)
    onehot = F.one_hot(labels, logits.shape[-1]).float()
    axes = (1, 2, 3)
    inter = (onehot * probs).sum(axes)
    denom = onehot.square().sum(axes) + probs.square().sum(axes) + 1e-6
    dice = (1.0 - 2.0 * inter / denom).mean()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return dice + ce


def ctunet_loss(outs, labels: torch.Tensor) -> torch.Tensor:
    """(res, res 48, res 24), (vit, vit 96) against (B, X, Y, Z) labels."""
    (res, res48, res24), (vit, vit96) = outs
    half = zoom_nearest(labels, (0.5, 0.5, 1.0))
    quarter = zoom_nearest(labels, (0.25, 0.25, 0.5))
    cunet = dice_ce(res, labels) + 0.5 * (dice_ce(res48, half) + 0.5 * dice_ce(res24, quarter))
    return cunet + 0.5 * (dice_ce(vit, labels) + dice_ce(vit96, labels))


class AdamW:
    """torch's AdamW update, written out: decay ``p *= 1 - lr wd``, then
    ``p -= lr m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params, lr: float, weight_decay: float, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_steps(model, batches: List[Tuple[torch.Tensor, torch.Tensor]], lr: float,
                weight_decay: float) -> Dict[str, object]:
    """Steps of ``model`` on ``batches`` ((S, X, Y, Z, 1) image, label) on
    the model's device: each step's loss, the first step's gradient of each
    parameter, and the parameters after the last step."""
    opt = AdamW(model.parameters(), lr, weight_decay)
    names = [n for n, _ in model.named_parameters()]
    losses, first_grads = [], None
    for image, label in batches:
        model.zero_grad(set_to_none=True)
        total = 0.0
        n = image.shape[0]
        for i in range(n):
            loss = ctunet_loss(model(image[i:i + 1].float()), label[i:i + 1, ..., 0].long()) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if first_grads is None:
            first_grads = {k: p.grad.detach().clone() for k, p in zip(names, opt.params)}
        opt.step()
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: p.detach().clone() for k, p in zip(names, opt.params)}}
