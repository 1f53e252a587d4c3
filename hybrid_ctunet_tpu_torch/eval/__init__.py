"""Evaluation and postprocessing: per-organ Dice/HD95 metrics, nnU-Net-style
largest-connected-component postprocessing and the dice.txt report writer
(reference test_CTUNet_final.py:83-401 and test_CTUNet.py:219-326). Port of
``hybrid_ctunet_tpu/eval``."""
from .metrics import (
    BTCV_ORGANS,
    com_dice,
    com_hd,
    dice_score,
    hd95,
    per_organ_dice,
    per_organ_hd95,
    process_label,
)
from .postprocess import determine_postprocessing, remove_all_but_largest_component
from .report import REPORT_LABELS, write_dice_report

__all__ = [
    "BTCV_ORGANS",
    "process_label",
    "dice_score",
    "hd95",
    "per_organ_dice",
    "per_organ_hd95",
    "com_dice",
    "com_hd",
    "remove_all_but_largest_component",
    "determine_postprocessing",
    "write_dice_report",
    "REPORT_LABELS",
]
