"""get_loader: the train/val data pipeline from an args namespace
(reference utils/data_utils.py:69-219). Port of
``hybrid_ctunet_tpu/data/loader.py``.

Returns ``(train_loader, val_cases)``: ``train_loader`` yields channels-last
crop batches, ``val_cases`` are whole preprocessed volumes with native-grid
labels and the metadata to invert predictions (the reference keeps
validation labels native and inverts its predictions,
data_utils.py:103-115). In ``test_mode`` only the validation cases are
built.
"""
from __future__ import annotations

import os

from .datalist import load_decathlon_datalist
from .dataset import CachedDataset, ShardSampler, TrainLoader


def get_loader(args, *, num_replicas: int = 1, rank: int = 0):
    """args needs: data_dir, json_list, batch_size, roi_x/y/z, space_x/y/z,
    a_min/a_max/b_min/b_max, the four Rand*_prob, use_normal_dataset. With
    ``args.test_mode`` only the validation cases are built: ``(None,
    val_cases)``, no training file read. Under ``args.distributed`` (or
    more than one replica) the train cases are sharded over the ranks by a
    :class:`ShardSampler`; every rank keeps every validation case (the
    sliding window shards their windows instead)."""
    from ..train.trainer import ValCase

    json_path = os.path.join(args.data_dir, args.json_list)
    roi = (args.roi_x, args.roi_y, args.roi_z)
    kw = dict(pixdim=(args.space_x, args.space_y, args.space_z), a_min=args.a_min,
              a_max=args.a_max, b_min=args.b_min, b_max=args.b_max)

    val_files = load_decathlon_datalist(json_path, data_list_key="validation",
                                        base_dir=args.data_dir)
    val_ds = CachedDataset(val_files, cache_num=len(val_files), resample_labels=False, **kw)
    val_cases = []
    for i in range(len(val_ds)):
        img, lab, meta, item = val_ds.get(i)
        name = os.path.basename(item.get("image", f"case_{i}"))
        val_cases.append(ValCase(image=img, label=lab, meta=meta, name=name))

    if getattr(args, "test_mode", False):
        return None, val_cases

    train_files = load_decathlon_datalist(json_path, data_list_key="training",
                                          base_dir=args.data_dir)
    # --use_normal_dataset: uncached, reloaded per epoch (the reference's
    # monai Dataset fallback, data_utils.py:190-195)
    cache_num = 0 if getattr(args, "use_normal_dataset", False) else 24
    train_ds = CachedDataset(train_files, cache_num=cache_num, resample_labels=True, **kw)
    aug_cfg = dict(
        RandFlipd_prob=args.RandFlipd_prob,
        RandRotate90d_prob=args.RandRotate90d_prob,
        RandScaleIntensityd_prob=args.RandScaleIntensityd_prob,
        RandShiftIntensityd_prob=args.RandShiftIntensityd_prob,
    )
    sampler = None
    if getattr(args, "distributed", False) or num_replicas > 1:
        sampler = ShardSampler(len(train_ds), num_replicas, rank, shuffle=True, make_even=True)
    train_loader = TrainLoader(train_ds, batch_size=args.batch_size, roi_size=roi,
                               num_samples=4, sampler=sampler, aug_cfg=aug_cfg)
    return train_loader, val_cases
