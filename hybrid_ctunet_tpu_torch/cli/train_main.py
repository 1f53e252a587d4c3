"""Training entry point (reference main_C_TUNet.py:100-249 /
main_CTUNet.py:97-227). Port of ``hybrid_ctunet_tpu/cli/train_main.py``.

    python -m hybrid_ctunet_tpu_torch.cli.train_main --synthetic \\
        --model_depths 101 --patch_frame 8 --max_epochs 2 --val_every 2 \\
        --warmup_epochs 1 --save_checkpoint --logdir /path/to/run \\
        [--dropout_rate 0.2] [--norm_name batch] [--distributed]

Run as a module it is main_CTUNet.py's entry, ``main("ctunet")`` (the model
is CTUNet whatever ``--model_name`` says, as there); ``main("c_tunet")`` is
main_C_TUNet.py's, which takes ``--model_name cunet | tunet | ctunet``. It
runs on the card unless ``--device cpu`` is given. Logs and checkpoints go to
``./runs/<logdir>`` (an absolute ``--logdir`` is used as it is).

``--distributed`` spawns one process per GPU (``parallel.mesh.launch``, the
reference's mp.spawn + NCCL; one process a node with gloo under ``--device
cpu``), trains through DDP (``parallel.dp.make_dp_train_step``) on each
rank's shard of the cases, and validates on every rank through the
rank-sharded sliding window; rank 0 prints, logs and writes the checkpoints.
"""
from __future__ import annotations

import os
import sys

from ..data.loader import get_loader
from ..parallel.mesh import is_main_process, launch, rank_and_world
from ..train.steps import make_train_step
from ..train.trainer import TrainConfig, run_training
from .args import build_train_parser
from .factory import (build_model, build_optimizer, check_supported, restore,
                      select_device)


def main(entry: str = "ctunet", argv=None):
    args = build_train_parser(entry).parse_args(argv)
    if entry == "ctunet":
        args.model_name = "ctunet"
    check_supported(args)
    select_device(args)
    if args.synthetic:
        from ..data.synthetic import write_synthetic_dataset

        os.makedirs(args.data_dir, exist_ok=True)
        path = write_synthetic_dataset(args.data_dir, n_classes=args.out_channels)
        args.json_list = os.path.basename(path)
    if args.distributed:
        return launch(main_worker, args)
    return main_worker(args)


def main_worker(args):
    """Train on this process's device; under a process group, one rank of
    the data-parallel run."""
    device = select_device(args)
    rank, world = rank_and_world()
    train_loader, val_cases = get_loader(args, num_replicas=world, rank=rank)

    model = build_model(args, device)
    optimizer = build_optimizer(args, model)
    start_epoch, _ = restore(args, model, optimizer)
    if is_main_process():
        print(f"Total parameters count {sum(p.numel() for p in model.parameters())}")

    cfg = TrainConfig(
        model_name=args.model_name,
        max_epochs=args.max_epochs,
        warmup_epochs=args.warmup_epochs,
        val_every=args.val_every,
        optim_lr=args.optim_lr,
        lrschedule=args.lrschedule,
        roi_size=(args.roi_x, args.roi_y, args.roi_z),
        # the reference ignores --sw_batch_size in validation and uses 4
        # (trainer_CTUNet.py:189)
        sw_batch_size=4,
        infer_overlap=args.infer_overlap,
        logdir=os.path.join("./runs", args.logdir),
        out_channels=args.out_channels,
        save_checkpoint=args.save_checkpoint,
    )
    # the steps taken before start_epoch, one per batch: a resumed run draws
    # new dropout masks, as the JAX step's restored state.step does
    kw = dict(smooth_nr=args.smooth_nr, smooth_dr=args.smooth_dr, grad_accum=args.grad_accum,
              start_step=start_epoch * len(train_loader))
    if args.distributed:
        from ..parallel.dp import make_dp_train_step

        step_fn = make_dp_train_step(args.model_name, model, optimizer, **kw)
    else:
        step_fn = make_train_step(args.model_name, model, optimizer, **kw)
    best = run_training(model, optimizer, step_fn, train_loader, val_cases, cfg, device=device,
                        start_epoch=start_epoch)
    if is_main_process():
        print("best accuracies:", best)
    return best


if __name__ == "__main__":
    main("ctunet", sys.argv[1:])
