"""Model, optimizer and restore from a parsed args namespace (the
model-select and optimizer blocks of the reference mains,
main_C_TUNet.py:132-219, main_CTUNet.py:128-208). Port of
``hybrid_ctunet_tpu/cli/factory.py``.

A flag the port refuses (``--resume_jit``, as the JAX package does) exits
with a message, never silently ignored.
"""
from __future__ import annotations

import os

import torch

from ..models import CTUNet, CUNet, TUNet
from ..models.layers import convert_sync_batchnorm
from ..train.checkpoint import load_weights
from ..train.state import make_optimizer
from ..utils.params import random_init_

SEED = 0  # random initial weights (the JAX package inits from PRNGKey(0))


def check_supported(args) -> None:
    """Exit on the flags the port refuses: a ``--norm_name`` other than
    ``instance`` and ``batch``, and ``--resume_jit``, which the JAX package
    refuses too."""
    if args.norm_name not in ("instance", "batch"):
        raise SystemExit(f"--norm_name {args.norm_name!r} is not supported: 'instance' (the "
                         "reference default) and 'batch' (BatchNorm3d; SyncBatchNorm under "
                         "--distributed, reference main_C_TUNet.py:193-194) are implemented")
    if args.resume_jit:
        raise SystemExit("--resume_jit loads a TorchScript module (reference "
                         "main_C_TUNet.py:159), which the JAX package refuses too. Use a "
                         "state_dict .pt with --resume_ckpt or --checkpoint.")


def load_eval_weights(model: torch.nn.Module, path: str):
    """Weights-only load of the test entries (the JAX package's
    ``load_eval_params``): a reference-format ``.pt`` / ``.pth`` file, the
    port's checkpoints and the reference's, into ``model``; returns the
    file's dict. Orbax checkpoint directories are the JAX package's own
    format and exit with a message."""
    if os.path.isdir(path) or not path.endswith((".pt", ".pth")):
        raise SystemExit(f"{path}: not a .pt / .pth file; orbax checkpoint directories are "
                         "the JAX package's format. Save a state_dict .pt instead.")
    return load_weights(model, path)


def select_device(args) -> torch.device:
    """``--device``: a CUDA device unless ``cpu`` is asked for; no silent
    fallback to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: pass --device cpu to run on the CPU")
    return device


def model_dtype(args):
    # the reference trains with AMP unless --noamp: bf16 compute, fp32 params
    return torch.float32 if args.noamp else torch.bfloat16


def build_model(args, device) -> torch.nn.Module:
    """The model of ``args.model_name`` on ``device``, random weights from
    SEED, with ``--dropout_rate`` (the ViT-side sites; CUNet has none, as
    in the JAX package) and ``--norm_name``; under ``--distributed`` with a
    world of more than one process BatchNorm's moments are synced over it
    (SyncBatchNorm, reference main_C_TUNet.py:193-194; the JAX
    ``"batch:data"``)."""
    name = args.model_name
    common = dict(out_channels=args.out_channels, in_channels=args.in_channels,
                  norm_name=args.norm_name, dtype=model_dtype(args), device=device)
    vit_kw = dict(img_size=(args.roi_x, args.roi_y), frames=args.roi_z,
                  patch_frame=args.patch_frame, hidden_size=args.hidden_size,
                  num_depths=args.num_depths, mlp_dim=args.mlp_dim, num_heads=args.num_heads,
                  dim_conv_stem=args.feature_size, window=args.window,
                  dropout_rate=args.dropout_rate)
    if name == "cunet":
        model = CUNet(model_depth=args.model_depths, **common)
    elif name == "tunet":
        model = TUNet(**vit_kw, **common)
    elif name == "ctunet":
        model = CTUNet(model_depth=args.model_depths, **vit_kw, **common)
    else:
        raise ValueError(f"Unsupported model_name: {name!r} (cunet | tunet | ctunet)")
    if args.distributed and args.world_size > 1:
        convert_sync_batchnorm(model)
    return random_init_(model, SEED)


def build_optimizer(args, model: torch.nn.Module) -> torch.optim.Optimizer:
    return make_optimizer(model.parameters(), args.optim_name, reg_weight=args.reg_weight,
                          momentum=args.momentum)


def restore(args, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """``--resume_ckpt`` (weights only, from pretrained_dir /
    pretrained_model_name, main_C_TUNet.py:154-157) and ``--checkpoint``
    (weights, and the optimizer, epoch and best accuracy where the file has
    them). Returns (start_epoch, best_acc)."""
    start_epoch, best_acc = 0, 0.0
    if args.resume_ckpt:
        load_weights(model, os.path.join(args.pretrained_dir, args.pretrained_model_name))
        print("Use pretrained weights")
    if args.checkpoint:
        ckpt = load_weights(model, args.checkpoint)
        if "optimizer" in ckpt:
            optimizer.load_state_dict(ckpt["optimizer"])
        start_epoch = int(ckpt.get("epoch", 0))
        best_acc = float(ckpt.get("best_acc", 0.0))
        print(f"=> loaded checkpoint {args.checkpoint} (epoch {start_epoch}) "
              f"(bestacc {best_acc})")
    return start_epoch, best_acc
