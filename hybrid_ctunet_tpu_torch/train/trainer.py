"""The training loop for CUNet, TUNet and CTUNet. Port of
``hybrid_ctunet_tpu/train/trainer.py``.

Behaviour (reference trainer_CUNet.py:195-265, trainer_TUNet.py,
trainer_CTUNet.py:320-414):

- epochs over a ``TrainLoader`` reseeded per epoch;
- the LR from the per-epoch schedule (stepped per epoch, not per step);
- every ``val_every`` epochs, whole-volume sliding-window validation (ROI
  windows, sw_batch 4, gaussian), the predictions inverted to the native
  label grid, the mean per-organ Dice over classes 1..n-1;
- best-metric checkpoints: CUNet -> ``model_res.pt``, TUNet ->
  ``model_vit.pt`` (trainer_CUNet.py:216-219); CTUNet keeps three best
  metrics and files: the softmax mean of both heads -> ``model_hybrid.pt``,
  the res head -> ``model_res.pt``, the vit head -> ``model_vit.pt``
  (trainer_CTUNet.py:339-341, 382-405); and ``latest.pt`` at every
  validation epoch, for restarts;
- scalars under the reference's tag names;
- under a process group, prints, scalars and checkpoints on rank 0 only
  (JAX ``trainer.py:221-275``); validation runs on every rank through the
  rank-sharded engine, so every rank takes the same best-metric decision.

The deep-supervision targets are downscaled on the device inside the step,
and bf16 compute takes the place of AMP.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.transforms import invert_to_native
from ..eval.metrics import per_organ_dice
from ..infer.sliding_window import SlidingWindowEngine
from ..parallel.mesh import is_main_process, rank_and_world
from ..utils.logging import AverageMeter, ScalarWriter
from .checkpoint import save_checkpoint
from .schedule import make_epoch_schedule

# losses are read on the host every few steps, not every step, so the host
# keeps queueing work; the per-step lines still print, in batches
FETCH_EVERY = 8


@dataclass
class TrainConfig:
    model_name: str = "ctunet"
    max_epochs: int = 5000
    warmup_epochs: int = 50
    val_every: int = 100
    optim_lr: float = 1e-4
    lrschedule: str = "warmup_cosine"
    roi_size: Tuple[int, int, int] = (96, 96, 96)
    sw_batch_size: int = 4
    infer_overlap: float = 0.5
    logdir: Optional[str] = None
    out_channels: int = 14
    save_checkpoint: bool = True


@dataclass
class ValCase:
    """One validation case: the preprocessed image volume, the native-grid
    label and the metadata that inverts a prediction to that grid."""

    image: np.ndarray  # (X, Y, Z[, 1]) preprocessed
    label: np.ndarray  # native grid (validation labels are not resampled)
    meta: object  # transforms.CaseMeta
    name: str = ""


def _channels_last(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return (t[..., None] if t.ndim == 4 else t).to(device)


def train_epoch(step_fn: Callable, loader, lr: float, *, epoch: int, device) -> float:
    """One epoch of train steps, a line per step (rank 0); returns the mean
    loss."""
    meter = AverageMeter()
    pending = []  # (loss on the device, batch size, step, host seconds)
    n_batches = len(loader)
    verbose = is_main_process()

    def drain():
        for loss_dev, n, idx, dt in pending:
            loss = float(loss_dev)
            meter.update(loss, n=n)
            if verbose:
                print(f"Epoch {epoch} {idx}/{n_batches} loss: {loss:.4f} time {dt:.2f}s")
        pending.clear()

    t0 = time.time()
    for i, (image, label) in enumerate(loader):
        metrics = step_fn(_channels_last(image, device).float(),
                          _channels_last(label, device), lr)
        pending.append((metrics["loss"], image.shape[0], i, time.time() - t0))
        t0 = time.time()
        if len(pending) >= FETCH_EVERY:
            drain()
    drain()
    return float(meter.avg)


def make_val_engine(model: torch.nn.Module, cfg: TrainConfig, *,
                    dual_output: bool) -> SlidingWindowEngine:
    """The validation engine: CTUNet's full-resolution res and vit heads
    (dual output), or the first head of CUNet / TUNet; sharded over the
    ranks of the process group, where there is one."""

    def predictor(x):
        outs = model(x)
        if dual_output:
            return outs[0][0], outs[1][0]
        return outs[0]

    rank, world = rank_and_world()
    return SlidingWindowEngine(predictor, cfg.roi_size, sw_batch_size=cfg.sw_batch_size,
                               overlap=cfg.infer_overlap, num_outputs=2 if dual_output else 1,
                               rank=rank, world=world)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _dice_of_logits(native_logits: np.ndarray, label: np.ndarray, n_classes: int) -> np.ndarray:
    return per_organ_dice(np.argmax(native_logits, axis=-1), label, n_classes=n_classes)


def val_epoch(model: torch.nn.Module, engine: SlidingWindowEngine, val_cases: Sequence[ValCase],
              cfg: TrainConfig, *, dual_output: bool, device) -> Tuple[float, ...]:
    """Whole-volume validation: (acc_hybrid, acc_res, acc_vit) for CTUNet,
    else (acc,); each the mean over cases of the mean per-organ Dice
    (reference val_epoch / val_epoch_hybrid). ``engine`` runs ``model``,
    which is put in eval mode for the pass and left in the mode it had."""
    was_training = model.training
    model.eval()
    try:
        return _val_accuracies(engine, val_cases, cfg, dual_output=dual_output, device=device)
    finally:
        model.train(was_training)


def _val_accuracies(engine: SlidingWindowEngine, val_cases: Sequence[ValCase], cfg: TrainConfig,
                    *, dual_output: bool, device) -> Tuple[float, ...]:
    accs: List[List[float]] = [[] for _ in range(3 if dual_output else 1)]
    for case in val_cases:
        img = np.asarray(case.image, np.float32)
        vol = torch.from_numpy(img if img.ndim == 4 else img[..., None])[None].to(device)
        lab = np.asarray(case.label)
        lab = lab[..., 0] if lab.ndim == 4 else lab
        with torch.inference_mode():
            outs = [o[0].cpu().numpy() for o in engine(vol)]
        if dual_output:
            res_nat, vit_nat = (invert_to_native(o, case.meta) for o in outs)
            prob = (_softmax(res_nat) + _softmax(vit_nat)) / 2.0
            dices = (per_organ_dice(np.argmax(prob, -1), lab, n_classes=cfg.out_channels),
                     _dice_of_logits(res_nat, lab, cfg.out_channels),
                     _dice_of_logits(vit_nat, lab, cfg.out_channels))
        else:
            dices = (_dice_of_logits(invert_to_native(outs[0], case.meta), lab,
                                     cfg.out_channels),)
        for a, d in zip(accs, dices):
            a.append(float(np.mean(d)))
    return tuple(float(np.mean(a)) for a in accs)


def run_training(model: torch.nn.Module, optimizer: torch.optim.Optimizer, step_fn: Callable,
                 train_loader, val_cases: Sequence[ValCase], cfg: TrainConfig, *, device,
                 start_epoch: int = 0) -> Dict[str, float]:
    """The reference's run_training; returns the best accuracies."""
    dual = cfg.model_name == "ctunet"
    main = is_main_process()
    writer = ScalarWriter(cfg.logdir if main else None)
    ckpt_dir = cfg.logdir or "."
    engine = make_val_engine(model, cfg, dual_output=dual)
    schedule = make_epoch_schedule(cfg.lrschedule, base_lr=cfg.optim_lr,
                                   warmup_epochs=cfg.warmup_epochs, max_epochs=cfg.max_epochs)
    best = {"hybrid": 0.0, "res": 0.0, "vit": 0.0} if dual else {"acc": 0.0}

    def save(fname, epoch, acc):
        if cfg.save_checkpoint and main:
            save_checkpoint(ckpt_dir, fname, model, optimizer, epoch=epoch, best_acc=acc)

    try:
        for epoch in range(start_epoch, cfg.max_epochs):
            train_loader.set_epoch(epoch)
            lr = schedule(epoch)
            model.train()
            t0 = time.time()
            train_loss = train_epoch(step_fn, train_loader, lr, epoch=epoch, device=device)
            if main:
                print(f"Final training  {epoch}/{cfg.max_epochs - 1} loss: {train_loss:.4f} "
                      f"time {time.time() - t0:.2f}s")
            writer.add_scalar("train_loss", train_loss, epoch)
            if (epoch + 1) % cfg.val_every:
                continue
            save("latest.pt", epoch + 1, max(best.values()))
            if not val_cases:
                continue
            accs = val_epoch(model, engine, val_cases, cfg, dual_output=dual, device=device)
            if dual:
                named = list(zip(("hybrid", "res", "vit"), accs,
                                 ("model_hybrid.pt", "model_res.pt", "model_vit.pt")))
                for key, acc, _ in named:
                    writer.add_scalar(f"val_acc_{key}", acc, epoch)
            else:
                # model_res.pt for cunet, model_vit.pt for tunet (trainer_CUNet.py:216-219)
                fname = "model_res.pt" if cfg.model_name == "cunet" else "model_vit.pt"
                named = [("acc", accs[0], fname)]
                writer.add_scalar("val_acc", accs[0], epoch)
            for key, acc, fname in named:
                if acc > best[key]:
                    if main:
                        print(f"new best ({best[key]:.6f} --> {acc:.6f})")
                    best[key] = acc
                    save(fname, epoch, acc)
    finally:
        writer.close()
    return best
