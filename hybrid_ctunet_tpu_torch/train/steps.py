"""The train step with the reference's loss structure. Port of
``hybrid_ctunet_tpu/train/steps.py``.

Channels-last batches: image (B, X, Y, Z, 1), label (B, X, Y, Z, 1).

- CUNet  (trainer_CUNet.py:91-100):
    L = DiceCE(out0, y) + 0.5 (DiceCE(out1, y_half) + 0.5 DiceCE(out2, y_quarter)),
  y_half the nearest zoom (.5, .5, 1) of y, y_quarter (.25, .25, .5), on the
  device;
- TUNet  (trainer_TUNet.py:78-82): L = DiceCE(v0, y) + DiceCE(v1, y);
- CTUNet (trainer_CTUNet.py:90-103): L = L_cunet + 0.5 L_tunet;
- Swin-UNETR: L = DiceCE(logits, y) on its one output.

A step is forward, loss, backward and one optimizer update at the epoch's
LR. ``grad_accum`` splits the batch into microbatches whose gradients add up
before the one update: exact, since neither InstanceNorm nor the losses
couple samples (BatchNorm normalizes each microbatch over its own samples
and folds its running buffers microbatch by microbatch, as the JAX step
does).

Dropout masks come from the step's own ``torch.Generator`` on the model's
device, reseeded for each microbatch from (``DROPOUT_SEED``, ``rank``, step,
microbatch): the JAX step folds the step and the microbatch into
``PRNGKey(0)`` (``train/steps.py:119-122,169-173``) and its DP step the
shard index (``parallel/dp.py:51-55``). Masks cannot equal JAX's.

``remat``: the whole forward is rematerialized in the backward (the JAX
``compute_grads(remat=True)``'s ``jax.checkpoint``), on top of the blocks
that ``models.layers.maybe_remat`` wraps.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.layers import Dropout, remat, set_dropout_generator
from ..ops.losses import dice_ce_loss
from ..ops.resize import downscale_labels
from ..utils import profiling
from .state import set_learning_rate


def deep_supervision_loss(outs, label, *, smooth_nr=0.0, smooth_dr=1e-6):
    """CUNet's loss over the (full, 1/2, 1/4) heads."""
    out0, out1, out2 = outs
    y1 = downscale_labels(label, (0.5, 0.5, 1.0))
    y2 = downscale_labels(label, (0.25, 0.25, 0.5))
    kw = dict(smooth_nr=smooth_nr, smooth_dr=smooth_dr)
    l0 = dice_ce_loss(out0, label, **kw)
    l1 = dice_ce_loss(out1, y1, **kw)
    l2 = dice_ce_loss(out2, y2, **kw)
    return l0 + 0.5 * (l1 + 0.5 * l2)


def dual_head_loss(outs, label, *, smooth_nr=0.0, smooth_dr=1e-6):
    """TUNet's loss: both full-resolution heads against the label."""
    v0, v1 = outs
    kw = dict(smooth_nr=smooth_nr, smooth_dr=smooth_dr)
    return dice_ce_loss(v0, label, **kw) + dice_ce_loss(v1, label, **kw)


def cunet_loss_fn(outs, label, **kw):
    return deep_supervision_loss(outs, label, **kw), {}


def tunet_loss_fn(outs, label, **kw):
    return dual_head_loss(outs, label, **kw), {}


def ctunet_loss_fn(outs, label, **kw):
    res_outs, vit_outs = outs
    loss1 = deep_supervision_loss(res_outs, label, **kw)
    loss2 = dual_head_loss(vit_outs, label, **kw)
    return loss1 + 0.5 * loss2, {"loss1": loss1, "loss2": loss2}


def single_loss_fn(outs, label, *, smooth_nr=0.0, smooth_dr=1e-6):
    (logits,) = outs
    return dice_ce_loss(logits, label, smooth_nr=smooth_nr, smooth_dr=smooth_dr), {}


LOSS_FNS = {"cunet": cunet_loss_fn, "tunet": tunet_loss_fn, "ctunet": ctunet_loss_fn,
            "swin_unetr": single_loss_fn}


DROPOUT_SEED = 0  # the JAX steps' default dropout_seed


def dropout_seed_of(rank: int, step: int, microbatch: int) -> int:
    """The generator seed of one microbatch's masks."""
    return int(np.random.SeedSequence([DROPOUT_SEED, rank, step, microbatch])
               .generate_state(1, np.uint64)[0] >> 1)


class Rematerialized(nn.Module):
    """``model`` whose whole forward is rematerialized in the backward
    (:func:`models.layers.remat`). Under DDP it goes inside the wrapper:
    a DDP forward must not run again in the backward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return remat(self.model, x)


class TrainStep:
    """``step(image, label, lr) -> {"loss": ..., **aux}``: tensors on
    ``image``'s device, detached; the model's parameters, buffers and the
    optimizer state are updated in place. ``model`` may be wrapped (a
    ``DistributedDataParallel``); its gradients are then synced once a
    step, at the last microbatch. ``self.step`` counts the steps taken,
    from ``start_step`` (a resumed run's saved count, so that it draws new
    masks, as the JAX step's restored ``state.step`` does). Under a
    profiler a step is the span ``step`` (unit ``self.step``, owner
    ``self.owner``) around ``step.forward`` (forward and loss),
    ``step.backward`` (a microbatch each) and ``step.optimizer``. ``remat``:
    the forward runs through :class:`Rematerialized` (not for a DDP
    ``model``: ``parallel.dp.make_dp_train_step`` wraps it inside)."""

    def __init__(self, model_name: str, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, *, smooth_nr: float = 0.0,
                 smooth_dr: float = 1e-6, grad_accum: int = 1, rank: int = 0,
                 start_step: int = 0, remat: bool = False):
        if remat:
            if hasattr(model, "no_sync"):
                raise ValueError("remat of a DDP model: wrap its module in Rematerialized")
            model = Rematerialized(model)
        self.loss_impl = LOSS_FNS[model_name]
        self.model, self.optimizer = model, optimizer
        self.loss_kw = dict(smooth_nr=smooth_nr, smooth_dr=smooth_dr)
        self.grad_accum, self.rank = grad_accum, rank
        self.step = start_step
        self.owner = profiling.new_owner()
        self.generator = None
        if any(isinstance(m, Dropout) and m.rate > 0 for m in model.modules()):
            device = next(model.parameters()).device
            self.generator = torch.Generator(device=device)
            set_dropout_generator(model, self.generator)

    def __call__(self, image: torch.Tensor, label: torch.Tensor,
                 lr: float) -> Dict[str, torch.Tensor]:
        B, accum = image.shape[0], self.grad_accum
        if B % accum:
            raise ValueError(f"batch {B} not divisible by grad_accum {accum}")
        mb = B // accum
        with profiling.span("step", self.step, self.owner):
            self.optimizer.zero_grad(set_to_none=True)
            metrics: Dict[str, torch.Tensor] = {}
            for i in range(accum):
                if self.generator is not None:
                    self.generator.manual_seed(
                        dropout_seed_of(self.rank, self.step, i))
                sl = slice(i * mb, (i + 1) * mb)
                sync = i == accum - 1 or not hasattr(self.model, "no_sync")
                with contextlib.nullcontext() if sync else self.model.no_sync():
                    with profiling.span("step.forward"):
                        loss, aux = self.loss_impl(self.model(image[sl]), label[sl],
                                                   **self.loss_kw)
                    with profiling.span("step.backward"):
                        (loss / accum).backward()
                for k, v in {"loss": loss, **aux}.items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach() / accum
            with profiling.span("step.optimizer"):
                set_learning_rate(self.optimizer, lr)
                self.optimizer.step()
            self.step += 1
        return metrics


def make_train_step(model_name: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    *, smooth_nr: float = 0.0, smooth_dr: float = 1e-6, grad_accum: int = 1,
                    rank: int = 0, start_step: int = 0, remat: bool = False) -> TrainStep:
    """The train step of ``model_name`` (see :class:`TrainStep`)."""
    return TrainStep(model_name, model, optimizer, smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                     grad_accum=grad_accum, rank=rank, start_step=start_step, remat=remat)
