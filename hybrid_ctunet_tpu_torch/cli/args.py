"""Reference-compatible argparse surfaces. Port of
``hybrid_ctunet_tpu/cli/args.py``.

Every flag of the reference mains is accepted with the same name, type and
default (main_C_TUNet.py:33-98; main_CTUNet.py's overrides per entry point).
Port notes:
- ``--device``      : ``cuda`` (default) or ``cpu``; without a card the entry
                      points refuse to run unless ``--device cpu`` is given.
- ``--noamp``       : AMP -> bf16 compute; --noamp selects fp32 compute.
- ``--distributed`` : one process per GPU (``--device cpu``: one per node,
                      gloo), the reference's launch (main_C_TUNet.py:104-121);
                      DDP training with rank-sharded validation, and the
                      test entries shard the sliding window over the ranks.
- ``--norm_name``   : ``instance`` (default) or ``batch``, SyncBatchNorm under
                      ``--distributed`` with more than one process.
- ``--dropout_rate``: dropout at the reference's sites, active in training.
- ``--resume_jit``  : exits, as in the JAX package (TorchScript).
- ``--workers``     : host preprocessing is cached once; kept for
                      compatibility.
"""
from __future__ import annotations

import argparse


def _common(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    add = parser.add_argument
    add("--checkpoint", default=None, help="start training from saved checkpoint")
    add("--logdir", default="test", type=str, help="directory to save the tensorboard logs")
    add("--pretrained_dir", default="./pretrained_models/", type=str,
        help="pretrained checkpoint directory")
    add("--data_dir", default="./dataset/dataset0/", type=str, help="dataset directory")
    add("--json_list", default="dataset_0.json", type=str, help="dataset json file")
    add("--pretrained_model_name", default="UNETR_model_best_acc.pth", type=str,
        help="pretrained model name")
    add("--save_checkpoint", action="store_true", help="save checkpoint during training")
    add("--max_epochs", default=5000, type=int, help="max number of training epochs")
    add("--batch_size", default=1, type=int, help="number of batch size")
    add("--sw_batch_size", default=1, type=int, help="number of sliding window batch size")
    add("--optim_lr", default=1e-4, type=float, help="optimization learning rate")
    add("--optim_name", default="adamw", type=str, help="optimization algorithm")
    add("--reg_weight", default=1e-5, type=float, help="regularization weight")
    add("--momentum", default=0.99, type=float, help="momentum")
    add("--noamp", action="store_true", help="do NOT use amp for training (fp32 compute)")
    add("--val_every", default=100, type=int, help="validation frequency")
    add("--distributed", action="store_true", help="start distributed training")
    add("--world_size", default=1, type=int, help="number of nodes for distributed training")
    add("--rank", default=0, type=int, help="node rank for distributed training")
    add("--dist-url", default="tcp://127.0.0.1:23456", type=str, help="distributed url")
    add("--dist-backend", default="nccl", type=str, help="distributed backend")
    add("--workers", default=8, type=int, help="number of workers")
    add("--pos_embed", default="perceptron", type=str, help="type of position embedding")
    add("--norm_name", default="instance", type=str, help="normalization layer type in decoder")
    add("--num_heads", default=12, type=int, help="number of attention heads in ViT encoder")
    add("--mlp_dim", default=3072, type=int, help="mlp dimention in ViT encoder")
    add("--hidden_size", default=768, type=int, help="hidden size dimention in ViT encoder")
    add("--feature_size", default=64, type=int, help="feature size dimention")
    add("--in_channels", default=1, type=int, help="number of input channels")
    add("--out_channels", default=14, type=int, help="number of output channels")
    add("--res_block", action="store_true", help="use residual blocks")
    add("--bottleneck_block", action="store_true", help="use bottleneck blocks")
    add("--conv_block", action="store_true", help="use conv blocks")
    add("--use_normal_dataset", action="store_true", help="use uncached dataset")
    add("--a_min", default=-175.0, type=float, help="a_min in ScaleIntensityRanged")
    add("--a_max", default=250.0, type=float, help="a_max in ScaleIntensityRanged")
    add("--b_min", default=0.0, type=float, help="b_min in ScaleIntensityRanged")
    add("--b_max", default=1.0, type=float, help="b_max in ScaleIntensityRanged")
    add("--space_x", default=1.5, type=float, help="spacing in x direction")
    add("--space_y", default=1.5, type=float, help="spacing in y direction")
    add("--space_z", default=2.0, type=float, help="spacing in z direction")
    add("--roi_x", default=96, type=int, help="roi size in x direction")
    add("--roi_y", default=96, type=int, help="roi size in y direction")
    add("--roi_z", default=96, type=int, help="roi size in z direction")
    add("--RandFlipd_prob", default=0.2, type=float, help="RandFlipd aug probability")
    add("--RandRotate90d_prob", default=0.2, type=float, help="RandRotate90d aug probability")
    add("--RandScaleIntensityd_prob", default=0.1, type=float,
        help="RandScaleIntensityd aug probability")
    add("--RandShiftIntensityd_prob", default=0.1, type=float,
        help="RandShiftIntensityd aug probability")
    add("--lrschedule", default="warmup_cosine", type=str, help="type of learning rate scheduler")
    add("--warmup_epochs", default=50, type=int, help="number of warmup epochs")
    add("--resume_ckpt", action="store_true", help="resume training from pretrained checkpoint")
    add("--resume_jit", action="store_true",
        help="resume training from pretrained torchscript checkpoint")
    add("--smooth_dr", default=1e-6, type=float,
        help="constant added to dice denominator to avoid nan")
    add("--smooth_nr", default=0.0, type=float,
        help="constant added to dice numerator to avoid zero")
    add("--num_depths", default=12, type=int, help="number of depths in ViT")
    add("--infer_overlap", default=0.5, type=float, help="sliding window inference overlap")
    add("--dropout_rate", default=0.0, type=float, help="dropout rate")
    add("--window", default=6, type=int,
        help="decoder window-attention size (an addition: the reference "
             "hardcodes 6, which only fits 96^3 inputs; smaller windows "
             "enable reduced-size runs)")
    add("--patch_frame", default=8, type=int, help="patch frame")
    add("--grad_accum", default=1, type=int,
        help="gradient-accumulation microbatches per optimizer step "
             "(an extension; exact math)")
    add("--synthetic", action="store_true",
        help="generate a synthetic BTCV-like dataset into data_dir (smoke runs)")
    add("--device", default="cuda", type=str,
        help="torch device: cuda (default) or cpu; refuses to run without a card "
             "unless cpu is given")
    return parser


def build_train_parser(entry: str) -> argparse.ArgumentParser:
    """entry: 'c_tunet' (reference main_C_TUNet.py) or 'ctunet'
    (main_CTUNet.py), with each entry's model_name / model_depths defaults.
    The reference main_CTUNet defaults (model_depths=50) disagree with its
    README commands (101 / patch_frame 8); the flag defaults are kept, and
    patch_frame=8 is the only shape-consistent value at 96^3."""
    p = argparse.ArgumentParser(description="hybrid-ctunet segmentation training (PyTorch)")
    _common(p)
    if entry == "ctunet":
        p.add_argument("--model_name", default="ctunet", type=str, help="model name")
        p.add_argument("--model_depths", default=50, type=int, help="resnet model depth")
    else:
        p.add_argument("--model_name", default="c_t_unet", type=str, help="model name")
        p.add_argument("--model_depths", default=101, type=int, help="resnet model depth")
    return p


def build_test_parser(entry: str) -> argparse.ArgumentParser:
    """The test scripts' surfaces (test_C_TUNet.py / test_CTUNet.py /
    test_CTUNet_final.py): the train flags plus the eval outputs."""
    p = build_train_parser("ctunet" if "ctunet" in entry else "c_tunet")
    p.add_argument("--exp_name", default="test1", type=str, help="experiment output dir name")
    p.add_argument("--postprocess", action="store_true",
                   help="largest-connected-component postprocessing (final ensemble)")
    return p
