"""Per-organ dice.txt report writer (reference test_CTUNet.py:219-326 /
test_CTUNet_final.py:559-606 format: a starred block per case with
``Dice_<organ>: x.xxxx`` lines, then a Mean_Dice block and the overall
``dsc:`` line).

The port's own copy of ``hybrid_ctunet_tpu/eval/report.py`` (numpy only; the
port imports nothing of the JAX package)."""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

# Reference label strings verbatim — including its 'veana' spelling — so
# reports remain diffable against reference outputs.
REPORT_LABELS = (
    "Dice_spleen",
    "Dice_right_kidney",
    "Dice_left_kidney",
    "Dice_gallbladder",
    "Dice_esophagus",
    "Dice_liver",
    "Dice_stomach",
    "Dice_aorta",
    "Dice_inferior_veana_cava",
    "Dice_portal_vein_splenic_vein",
    "Dice_pancreas",
    "Dice_right_adrenal_gland",
    "Dice_left_adrenal_gland",
)


def write_dice_report(
    output_directory: str,
    case_names: Sequence[str],
    per_case_dice: Sequence[Sequence[float]],
    *,
    filename: str = "dice.txt",
    extra_means: Dict[str, Sequence[Sequence[float]]] | None = None,
) -> str:
    """Append the per-case + mean dice report; returns the file path.

    ``per_case_dice``: (n_cases, 13) organ dice rows.
    ``extra_means``: optional named additional dice matrices (e.g. the
    res/vit single-head results) appended as extra mean blocks.
    """
    os.makedirs(output_directory, exist_ok=True)
    path = os.path.join(output_directory, filename)
    rows = np.asarray(per_case_dice, dtype=np.float64)
    assert rows.ndim == 2, rows.shape
    # BTCV gets the reference's organ labels; other class counts get
    # generic per-class labels
    if rows.shape[1] == len(REPORT_LABELS):
        labels = REPORT_LABELS
    else:
        labels = tuple(f"Dice_class_{i + 1}" for i in range(rows.shape[1]))

    with open(path, "a") as fw:
        for name, row in zip(case_names, rows):
            fw.write("*" * 20 + "\n")
            fw.write("case: " + str(name) + "\n")
            for lab, v in zip(labels, row):
                fw.write(f"{lab}: {v:.4f}\n")
        fw.write("*" * 20 + "\n")
        fw.write("Mean_Dice\n")
        means = rows.mean(0)
        for lab, v in zip(labels, means):
            fw.write(lab + str(v) + "\n")
        fw.write("*" * 20 + "\n")
        fw.write("dsc:" + str(float(means.mean())) + "\n")
        if extra_means:
            for name, mat in extra_means.items():
                m = np.asarray(mat, np.float64).mean(0)
                fw.write("*" * 20 + "\n")
                fw.write(f"Mean_Dice_{name}\n")
                for lab, v in zip(labels, m):
                    fw.write(lab + str(v) + "\n")
    return path
