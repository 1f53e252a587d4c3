"""nnU-Net-style largest-connected-component postprocessing.

Behavior contract = reference test_CTUNet_final.py:132-401:

``remove_all_but_largest_component`` removes, for each requested class (or
joint class tuple), every connected component except the largest — optionally
only components smaller than a per-class minimum valid size.

``determine_postprocessing`` decides, on a validation set, whether CC removal
helps: first treating all foreground as one joint region (kept only when at
least one organ improves and none gets worse), then per class (kept when that
class's dice improves), with the ``advanced`` mode deriving minimum valid
object sizes from the smallest kept component across cases. Returns the
processed predictions (and the decision record). CPU-parallel over cases via
a process pool — inherently sequential host work, exactly like the
reference's multiprocessing.Pool(8).

The port's own copy of ``hybrid_ctunet_tpu/eval/postprocess.py`` (numpy and
scipy only; the port imports nothing of the JAX package), with the same
results; it removes components in one pass over the volume, and its pool
spawns its workers.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from copy import deepcopy
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.ndimage import label as cc_label

from .metrics import com_dice

ALL_CLASSES = list(range(1, 14))


def remove_all_but_largest_component(
    image_in: np.ndarray,
    for_which_classes: Optional[Sequence],
    volume_per_voxel: float,
    minimum_valid_object_size: Optional[Dict] = None,
):
    """Per class (int) or joint region (tuple of ints), keep only the largest
    connected component; smaller ones are zeroed (unless >= the class's
    minimum valid size). Returns (image, largest_removed, kept_size) keyed by
    class, sizes in physical volume units."""
    image = image_in.copy()
    if for_which_classes is None:
        u = np.unique(image)
        for_which_classes = list(u[u > 0])
    assert 0 not in [c for c in for_which_classes if not isinstance(c, (list, tuple))], (
        "cannot remove background"
    )

    largest_removed: Dict = {}
    kept_size: Dict = {}
    for c in for_which_classes:
        if isinstance(c, (list, tuple)):
            c = tuple(c)
            mask = np.isin(image, c)
        else:
            mask = image == c
        lmap, num_objects = cc_label(mask.astype(int))
        largest_removed[c] = None
        kept_size[c] = None
        if num_objects == 0:
            continue
        sizes = np.bincount(lmap.ravel())[1:] * volume_per_voxel  # (num_objects,)
        maximum_size = sizes.max()
        kept_size[c] = float(maximum_size)
        # every component but the largest, or only those under the class's
        # minimum valid size: zeroed in one pass over the volume (the JAX
        # package's loop makes one pass per component, quadratic in a noisy
        # prediction's thousands of components)
        remove = sizes != maximum_size
        if minimum_valid_object_size is not None and remove.any():
            remove &= sizes < minimum_valid_object_size[c]
        if remove.any():
            image[np.concatenate(([False], remove))[lmap]] = 0
            largest_removed[c] = float(sizes[remove].max())
    return image, largest_removed, kept_size


def _aggregate_min_kept(results) -> Dict:
    """Smallest kept component size per class across cases (the 'advanced'
    minimum-valid-object-size heuristic)."""
    min_size_kept: Dict = {}
    for _largest_removed, kept in results:
        for k, v in kept.items():
            if v is not None:
                min_size_kept[k] = v if k not in min_size_kept else min(min_size_kept[k], v)
    return min_size_kept


def _run_all(pool, infers, classes_arg, volume_per_voxel, min_size):
    futs = [
        pool.submit(
            remove_all_but_largest_component, infers[i], classes_arg, volume_per_voxel[i], min_size
        )
        for i in range(len(infers))
    ]
    return [f.result() for f in futs]


def determine_postprocessing(
    infers: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    volume_per_voxel: Sequence[float],
    dice_threshold: float = 0.0,
    processes: int = 8,
    advanced_postprocessing: bool = False,
    classes: Optional[List[int]] = None,
    verbose: bool = True,
) -> List[np.ndarray]:
    """Decide + apply CC postprocessing on a validation set; returns the
    final processed predictions (reference test_CTUNet_final.py:193-401)."""
    classes = list(ALL_CLASSES if classes is None else classes)
    say = print if verbose else (lambda *a, **k: None)

    pp: Dict = {
        "dc_per_class_raw": {},
        "dc_per_class_pp_all": {},
        "dc_per_class_pp_per_class": {},
        "for_which_classes": [],
        "min_valid_object_sizes": {},
    }

    # spawned workers: the caller may hold threads (and a CUDA context),
    # which a forked child would inherit in whatever state they were in
    with ProcessPoolExecutor(max_workers=processes,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        # Pass 1: all foreground as one joint region.
        if advanced_postprocessing:
            res = _run_all(pool, infers, (classes,), volume_per_voxel, None)
            min_size_kept = _aggregate_min_kept([r[1:] for r in res])
            say("foreground vs background, smallest valid object size was",
                min_size_kept.get(tuple(classes)))
        else:
            min_size_kept = None

        res = _run_all(pool, infers, (classes,), volume_per_voxel, min_size_kept)
        infers_pp = [r[0] for r in res]
        # com_dice rows cover organs 1..13; index class cl at cl-1.
        dc_raw = com_dice(infers, labels, verbose=verbose)
        dc_pp_all = com_dice(infers_pp, labels, verbose=verbose)
        for cl in classes:
            pp["dc_per_class_raw"][str(cl)] = dc_raw[cl - 1]
            pp["dc_per_class_pp_all"][str(cl)] = dc_pp_all[cl - 1]

        say("Foreground vs background")
        say("before:", np.mean([dc_raw[cl - 1] for cl in classes]))
        say("after:", np.mean([dc_pp_all[cl - 1] for cl in classes]))
        do_fg_cc = False
        any_better = any(dc_pp_all[cl - 1] > dc_raw[cl - 1] + dice_threshold for cl in classes)
        any_worse = any(dc_pp_all[cl - 1] < dc_raw[cl - 1] for cl in classes)
        if any_better and not any_worse:
            pp["for_which_classes"].append(classes)
            if min_size_kept is not None:
                pp["min_valid_object_sizes"].update(deepcopy(min_size_kept))
            do_fg_cc = True
            say("Removing all but the largest foreground region improved results")

        # Pass 2: each class independently, on top of pass 1 if it was kept.
        if len(classes) > 1:
            source = infers_pp if do_fg_cc else list(infers)
            if advanced_postprocessing:
                res = _run_all(pool, source, classes, volume_per_voxel, None)
                min_size_kept = _aggregate_min_kept([r[1:] for r in res])
                say("classes treated separately, smallest valid object sizes are",
                    min_size_kept)
            else:
                min_size_kept = None

            res = _run_all(pool, source, classes, volume_per_voxel, min_size_kept)
            infers_pp_new = [r[0] for r in res]
            old_res = dc_pp_all if do_fg_cc else dc_raw
            dc_pp_cls = com_dice(infers_pp_new, labels, verbose=verbose)
            for cl in classes:
                pp["dc_per_class_pp_per_class"][cl] = dc_pp_cls[cl - 1]
                if dc_pp_cls[cl - 1] > old_res[cl - 1] + dice_threshold:
                    pp["for_which_classes"].append(int(cl))
                    if min_size_kept is not None:
                        pp["min_valid_object_sizes"][cl] = min_size_kept[cl]
                    say(f"Removing all but the largest region for class {cl} improved results!")

        if not advanced_postprocessing:
            pp["min_valid_object_sizes"] = None

        say("for which classes:", pp["for_which_classes"])
        say("min_object_sizes", pp["min_valid_object_sizes"])

        # Final application of the chosen rules to the raw predictions.
        res = _run_all(
            pool, infers, pp["for_which_classes"], volume_per_voxel, pp["min_valid_object_sizes"]
        )
        infers_final = [r[0] for r in res]

    return infers_final
