"""Evaluation entry points (reference test_C_TUNet.py / test_CTUNet.py /
test_CTUNet_final.py). Port of ``hybrid_ctunet_tpu/cli/test_main.py``.

    python -m hybrid_ctunet_tpu_torch.cli.test_main final --data_dir DIR \\
        --json_list dataset_0.json --ctunet_dir DIR --tunet_dir DIR \\
        --model_depths 101 [--postprocess]
    python -m hybrid_ctunet_tpu_torch.cli.test_main ctunet --pretrained_dir DIR ...
    python -m hybrid_ctunet_tpu_torch.cli.test_main single --model_name tunet \\
        --pretrained_dir DIR --pretrained_model_name model_vit.pt ...
    python -m hybrid_ctunet_tpu_torch.cli.test_main single --model_name swin_unetr \\
        --feature_size 48 --pretrained_dir DIR --pretrained_model_name model_vit.pt ...

All three share the loop: sliding-window infer each validation case ->
invert the blended logits to the native grid -> softmax/argmax (ensembling
where applicable) -> per-organ Dice (classes 1..13) -> NIfTI mask and
dice.txt report under ``./outputs/<exp_name>``. ``test_final`` adds the
Hybrid-CTUNet ensemble (CTUNet res head at overlap 0.5 + TUNet at 0.7,
softmax-mean, test_CTUNet_final.py:539-552), HD95, and optional nnU-Net
largest-CC postprocessing (:654-656). Each model runs in eval mode under
``torch.inference_mode()``, on the card unless ``--device cpu`` is given.
Checkpoints are reference-format ``.pt`` files (``factory.load_eval_weights``).

``--distributed`` spawns one process per GPU (``parallel.mesh.launch``) and
shards every sliding window's chunks over them (the JAX ``_eval_mesh``,
``cli/test_main.py:98-110``): each rank blends its chunks into its own
canvas, one all-reduce sums them; rank 0 alone inverts, scores and writes
the outputs, and returns the result.
"""
from __future__ import annotations

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..data.loader import get_loader
from ..data.nifti import save_nifti
from ..data.transforms import invert_to_native
from ..eval import com_dice, com_hd, determine_postprocessing, per_organ_dice, write_dice_report
from ..infer.sliding_window import SlidingWindowEngine
from ..models.layers import remat_blocks
from ..parallel.mesh import is_main_process, launch, rank_and_world
from .args import build_test_parser
from .factory import build_model, check_supported, load_eval_weights, select_device


def _softmax(x, axis=-1):
    x = x - x.max(axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis, keepdims=True)


def _dispatch(engine, model, case):
    """Device half of a case: enqueue the sliding-window chunks of ``model``
    and, behind them, the copies of the blended maps into pinned host
    memory. Returns (host maps, event); the card runs on while the caller
    goes on to the next case."""
    img = np.asarray(case.image, np.float32)
    device = next(model.parameters()).device
    vol = torch.from_numpy(img if img.ndim == 4 else img[..., None])[None].to(device)
    with torch.inference_mode():
        outs = engine(vol, model)
        if vol.device.type != "cuda":
            return outs, None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return host, done


def _to_native(handle, case, head: Optional[int] = None):
    """Host half: wait for the maps' copies and invert them to the native
    grid."""
    outs, done = handle
    if done is not None:
        done.synchronize()
    if head is None:
        return [invert_to_native(o[0].numpy(), case.meta) for o in outs]
    return invert_to_native(outs[head][0].numpy(), case.meta)


def _pipeline_cases(cases, dispatch, finish):
    """Depth-1 host/device pipeline over eval cases.

    ``dispatch(case)`` enqueues a case's device work and returns a handle;
    ``finish(case, handle)`` does the host work (fetch -> invert_to_native
    resample -> metrics -> NIfTI save). Case i's host work runs in a single
    worker thread while case i+1's windows run on the card. Results keep
    case order, identical to the serial loop's (the reference's loop,
    test_CTUNet_final.py:529-606, is serial); a worker's exception
    propagates.
    """
    if len(cases) <= 1:
        return [finish(c, dispatch(c)) for c in cases]
    results = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = None
        for case in cases:
            handle = dispatch(case)
            if pending is not None:
                results.append(pending.result())
            pending = ex.submit(finish, case, handle)
        results.append(pending.result())
    return results


def _label_of(case):
    lab = np.asarray(case.label)
    return lab[..., 0] if lab.ndim == 4 else lab


def _windows(x, model):
    """The windows in the model's compute type, as cli/bench.py gives them to
    TUNet and CTUNet (CUNet, which has no ``dtype``, casts in its layers)."""
    return x.to(getattr(model, "dtype", x.dtype))


def _engine(predictor, args, overlap=None, num_outputs=1):
    rank, world = rank_and_world()
    return SlidingWindowEngine(
        predictor, (args.roi_x, args.roi_y, args.roi_z), sw_batch_size=4,
        overlap=args.infer_overlap if overlap is None else overlap, num_outputs=num_outputs,
        rank=rank, world=world,
    )


def _single_engine(args, overlap=None):
    """The first head of CUNet / TUNet, Swin-UNETR's one; the model is the
    predictor's argument."""
    def predictor(x, model):
        return model(_windows(x, model))[0]

    return _engine(predictor, args, overlap)


def _dual_engine(args, overlap=None):
    """CTUNet's full-resolution res and vit heads."""
    def predictor(x, model):
        (res, _, _), (vit, _) = model(_windows(x, model))
        return res, vit

    return _engine(predictor, args, overlap, num_outputs=2)


def _load(args, device, model_name, path):
    """The model of ``model_name`` with the weights of ``path``, in eval
    mode on ``device``."""
    args.model_name = model_name
    model = build_model(args, device)
    load_eval_weights(model, path)
    return model.eval()


def _without_remat(entry, args):
    """``entry(args)`` with block remat off: evaluation never
    differentiates (the JAX ``cli/test_main.py:29``)."""
    with remat_blocks(False):
        return entry(args)


def _run(entry, args):
    """``entry(args)`` here, or in every rank under ``--distributed``
    (rank 0's result)."""
    args.test_mode = True
    check_supported(args)
    select_device(args)
    entry = functools.partial(_without_remat, entry)
    return launch(entry, args) if args.distributed else entry(args)


def _setup(args):
    device = select_device(args)
    _, val_cases = get_loader(args)
    out_dir = os.path.join("./outputs", args.exp_name)
    if is_main_process():
        os.makedirs(out_dir, exist_ok=True)
    return device, val_cases, out_dir


def _only_main(finish):
    """``finish`` on rank 0; the other ranks' part of a case ends with its
    windows."""
    return finish if is_main_process() else (lambda case, handle: None)


def test_single(argv=None):
    """test_C_TUNet.py: evaluate one CUNet, TUNet or Swin-UNETR checkpoint."""
    return _run(_test_single, build_test_parser("c_tunet").parse_args(argv))


def _test_single(args):
    device, val_cases, out_dir = _setup(args)
    model = _load(args, device, args.model_name,
                  os.path.join(args.pretrained_dir, args.pretrained_model_name))
    engine = _single_engine(args)

    def finish(case, handle):
        nat = _to_native(handle, case, head=0)
        pred = np.argmax(nat, -1)
        d = per_organ_dice(pred, _label_of(case), n_classes=args.out_channels)
        print(f"case {case.name} mean dice {np.mean(d):.4f}")
        save_nifti(os.path.join(out_dir, case.name or "pred.nii.gz"),
                   pred.astype(np.uint8), case.meta.affine)
        return case.name, d

    out = _pipeline_cases(val_cases, lambda c: _dispatch(engine, model, c), _only_main(finish))
    if not is_main_process():
        return None
    names, rows = [n for n, _ in out], [d for _, d in out]
    write_dice_report(out_dir, names, rows)
    print("Overall Mean Dice: {}".format(float(np.mean(rows))))
    return np.asarray(rows)


def test_ctunet(argv=None):
    """test_CTUNet.py: three-checkpoint evaluation — pass 1 ensembles the res
    head of model_res.pt with the vit head of model_vit.pt; pass 2 ensembles
    both heads of model_hybrid.pt (test_CTUNet.py:228-241, 340-391)."""
    return _run(_test_ctunet, build_test_parser("ctunet").parse_args(argv))


def _test_ctunet(args):
    device, val_cases, out_dir = _setup(args)
    m_res, m_vit, m_hyb = (_load(args, device, "ctunet", os.path.join(args.pretrained_dir, f))
                           for f in ("model_res.pt", "model_vit.pt", "model_hybrid.pt"))
    engine = _dual_engine(args)

    results = {}
    for tag, dispatch, fetch in (
        ("res+vit",
         lambda c: (_dispatch(engine, m_res, c), _dispatch(engine, m_vit, c)),
         lambda h, c: (_to_native(h[0], c, head=0), _to_native(h[1], c, head=1))),
        ("hybrid",
         lambda c: _dispatch(engine, m_hyb, c),
         lambda h, c: tuple(_to_native(h, c, head=None))),
    ):
        def finish(case, handle, tag=tag, fetch=fetch):
            m1, m2 = fetch(handle, case)
            prob = (_softmax(m1) + _softmax(m2)) / 2.0
            pred = np.argmax(prob, -1)
            d = per_organ_dice(pred, _label_of(case), n_classes=args.out_channels)
            save_nifti(os.path.join(out_dir, f"{tag}_{case.name or 'pred.nii.gz'}"),
                       pred.astype(np.uint8), case.meta.affine)
            return case.name, d

        out = _pipeline_cases(val_cases, dispatch, _only_main(finish))
        if not is_main_process():
            continue
        names, rows = [n for n, _ in out], [d for _, d in out]
        write_dice_report(out_dir, names, rows, filename=f"dice_{tag}.txt")
        print(f"[{tag}] Overall Mean Dice: {float(np.mean(rows))}")
        results[tag] = np.asarray(rows)
    return results if is_main_process() else None


def test_final(argv=None):
    """test_CTUNet_final.py: the Hybrid-CTUNet ensemble — CTUNet overlap 0.5
    + independent TUNet overlap 0.7, softmax-mean, Dice + HD95, optional
    largest-CC postprocessing."""
    parser = build_test_parser("ctunet")
    parser.add_argument("--ctunet_dir", default="./runs/CTUNet_ds8_dr0.2", type=str,
                        help="CTUNet checkpoint dir (reference hardcoded path)")
    parser.add_argument("--tunet_dir", default="./runs/TUNet_pf8", type=str,
                        help="independent TUNet checkpoint dir")
    return _run(_test_final, parser.parse_args(argv))


def _test_final(args):
    device, val_cases, out_dir = _setup(args)
    ctunet = _load(args, device, "ctunet", os.path.join(args.ctunet_dir, "model_res.pt"))
    tunet = _load(args, device, "tunet", os.path.join(args.tunet_dir, "model_vit.pt"))

    # the ensemble reads only the res head (reference
    # sliding_window_inference_multi(...)[0], test_CTUNet_final.py:539): the
    # res-only forward skips the ViT side's full-resolution branch and
    # accumulates no map that would be discarded
    def _ct_res_only(x, model):
        return model(_windows(x, model), res_only=True)

    eng_ct = _engine(_ct_res_only, args, overlap=0.5)
    eng_tu = _single_engine(args, overlap=0.7)

    def finish(case, handle):
        res_nat = _to_native(handle[0], case, head=0)
        tu_nat = _to_native(handle[1], case, head=0)
        prob = (_softmax(res_nat) + _softmax(tu_nat)) / 2.0
        pred = np.argmax(prob, -1).astype(np.uint8)
        # physical volume per voxel from the native affine (SimpleITK spacing
        # read, test_CTUNet_final.py:500-503)
        sp = float(np.abs(np.linalg.det(case.meta.affine[:3, :3])))
        save_nifti(os.path.join(out_dir, case.name or "pred.nii.gz"), pred, case.meta.affine)
        return pred, _label_of(case).astype(np.uint8), case.name, sp

    out = _pipeline_cases(
        val_cases,
        lambda c: (_dispatch(eng_ct, ctunet, c), _dispatch(eng_tu, tunet, c)),
        _only_main(finish),
    )
    if not is_main_process():
        return None
    infers = [r[0] for r in out]
    labels = [r[1] for r in out]
    names = [r[2] for r in out]
    vpv = [r[3] for r in out]

    rows = [per_organ_dice(p, l, n_classes=args.out_channels) for p, l in zip(infers, labels)]
    report_path = write_dice_report(out_dir, names, rows)
    dice_raw = com_dice(infers, labels)
    postprocessed = bool(args.postprocess)
    if postprocessed:
        # the reference reports the POST-postprocessing metrics
        # (test_CTUNet_final.py:654-656: determine_postprocessing -> com_dice
        # -> com_hd on infers_final)
        infers = determine_postprocessing(
            infers, labels, vpv, processes=min(8, os.cpu_count() or 1),
            advanced_postprocessing=True,
        )
    dice = com_dice(infers, labels)
    hd = com_hd(infers, labels)
    # the HD95 block goes into the report beside the dice rows
    with open(report_path, "a") as fw:
        fw.write("*" * 20 + "\n")
        fw.write("HD95 (mean per organ{}):\n".format(
            ", after postprocessing" if postprocessed else ""))
        for i, v in enumerate(np.asarray(hd).ravel()):
            fw.write(f"HD95_class_{i + 1}: {v:.4f}\n")
        fw.write(f"mean_hd95: {float(np.mean(hd)):.4f}\n")
        if postprocessed:
            fw.write(f"dsc_postprocessed: {float(np.mean(dice)):.4f}\n")
    return {"dice": dice, "dice_raw": dice_raw, "hd95": hd,
            "postprocessed": postprocessed}


ENTRIES = {"single": test_single, "ctunet": test_ctunet, "final": test_final}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ENTRIES:
        print(f"usage: python -m hybrid_ctunet_tpu_torch.cli.test_main "
              f"{{{'|'.join(ENTRIES)}}} [flags]", file=sys.stderr)
        return 2
    ENTRIES[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
