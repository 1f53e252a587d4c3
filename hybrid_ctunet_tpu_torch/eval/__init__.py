"""Evaluation metrics: per-organ Dice and HD95 (reference
test_CTUNet_final.py:83-130)."""
from .metrics import BTCV_ORGANS, com_dice, com_hd, dice_score, hd95, per_organ_dice, per_organ_hd95
