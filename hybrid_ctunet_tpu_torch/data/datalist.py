"""Decathlon-style JSON datalist loading (replaces monai.data.
load_decathlon_datalist, used at reference utils/data_utils.py:159-205).

The port's own copy of ``hybrid_ctunet_tpu/data/datalist.py`` (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List


def load_decathlon_datalist(
    json_path: str,
    is_segmentation: bool = True,
    data_list_key: str = "training",
    base_dir: str | None = None,
) -> List[Dict[str, str]]:
    with open(json_path) as f:
        spec = json.load(f)
    if data_list_key not in spec:
        raise ValueError(f"datalist key {data_list_key!r} not in {json_path}")
    base = base_dir if base_dir is not None else os.path.dirname(json_path)
    items = []
    for entry in spec[data_list_key]:
        if isinstance(entry, str):  # test split may be bare image paths
            entry = {"image": entry}
        out = dict(entry)
        for k in ("image", "label"):
            if k in out and not os.path.isabs(out[k]):
                out[k] = os.path.join(base, out[k])
        items.append(out)
    return items
