"""Training entry point (reference main_C_TUNet.py:100-249 /
main_CTUNet.py:97-227) on one device. Port of
``hybrid_ctunet_tpu/cli/train_main.py``.

    python -m hybrid_ctunet_tpu_torch.cli.train_main --synthetic \\
        --model_depths 101 --patch_frame 8 --max_epochs 2 --val_every 2 \\
        --warmup_epochs 1 --save_checkpoint --logdir /path/to/run

Run as a module it is main_CTUNet.py's entry, ``main("ctunet")`` (the model
is CTUNet whatever ``--model_name`` says, as there); ``main("c_tunet")`` is
main_C_TUNet.py's, which takes ``--model_name cunet | tunet | ctunet``. It
runs on the card unless ``--device cpu`` is given. Logs and checkpoints go to
``./runs/<logdir>`` (an absolute ``--logdir`` is used as it is).
"""
from __future__ import annotations

import os
import sys

from ..data.loader import get_loader
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
    device = select_device(args)

    if args.synthetic:
        from ..data.synthetic import write_synthetic_dataset

        os.makedirs(args.data_dir, exist_ok=True)
        path = write_synthetic_dataset(args.data_dir, n_classes=args.out_channels)
        args.json_list = os.path.basename(path)
    train_loader, val_cases = get_loader(args)

    model = build_model(args, device)
    optimizer = build_optimizer(args, model)
    start_epoch, _ = restore(args, model, optimizer)
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
    step_fn = make_train_step(args.model_name, model, optimizer, smooth_nr=args.smooth_nr,
                              smooth_dr=args.smooth_dr, grad_accum=args.grad_accum)
    best = run_training(model, optimizer, step_fn, train_loader, val_cases, cfg, device=device,
                        start_epoch=start_epoch)
    print("best accuracies:", best)
    return best


if __name__ == "__main__":
    main("ctunet", sys.argv[1:])
