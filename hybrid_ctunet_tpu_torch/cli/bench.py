"""The Hybrid-CTUNet ensemble's constructors.

The port's counterpart of the repository's ``bench.py`` (the ensemble of
``test_CTUNet_final.py``, ``cli/test_main.py test_final``): full-width CTUNet
(ResNet-101, pf 8, 174,109,542 params) at overlap 0.5 (50 windows), its res
head only, and the independent TUNet (pf 8, 109,904,124 params) at overlap
0.7 (147 windows); random weights from a seed, bf16 compute with fp32
params, one 256 x 256 x 128 volume, ROI 96^3, gaussian blending, windows
in chunks of ``sw`` (4 by default); then the fp32 softmax of each map,
their mean, argmax. The benchmark (``benchmark/drivers/``) and
``chip_smoke.py`` build their engines here; ``python3 -m benchmark.run``
measures them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..infer.sliding_window import SlidingWindowEngine
from ..models import CTUNet, TUNet
from ..utils.params import random_init_

VOLUME_SHAPE = (256, 256, 128)
ROI = (96, 96, 96)
OVERLAP = 0.7  # TUNet
CT_OVERLAP = 0.5  # CTUNet
SW_BATCH = 4
OUT_CHANNELS = 14


def set_precision_flags() -> None:
    """fp32 matmuls and convs in full fp32, bf16 GEMMs without reduced-
    precision reductions: the plain versions then sum as the JAX oracle does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _init(model, seed: int):
    """Random weights from ``seed``, in eval mode."""
    return random_init_(model, seed).eval()


def build_tunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> TUNet:
    """TUNet with random weights from ``seed`` (pf 8, 14 classes, full width
    unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, patch_frame=8)
    cfg.update(overrides)
    return _init(TUNet(dtype=dtype, device=device, **cfg), seed)


def build_ctunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> CTUNet:
    """CTUNet with random weights from ``seed`` (ResNet-101, pf 8, 14
    classes, full width unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, model_depth=101, patch_frame=8)
    cfg.update(overrides)
    return _init(CTUNet(dtype=dtype, device=device, **cfg), seed)


def make_engine(model: TUNet, roi=ROI, overlap: float = OVERLAP,
                sw: int = SW_BATCH) -> SlidingWindowEngine:
    """The eval CLI's single-output engine: the predictor returns the
    vit_logits head (cli/test_main.py ``_single_engine``)."""
    def predictor(x):
        return model(x.to(model.dtype))[0]

    return SlidingWindowEngine(predictor, roi, sw_batch_size=sw, overlap=overlap)


def make_ctunet_engine(model: CTUNet, roi=ROI, overlap: float = CT_OVERLAP,
                       sw: int = SW_BATCH) -> SlidingWindowEngine:
    """The ensemble's CTUNet engine: the predictor returns the res head alone
    (cli/test_main.py ``test_final``, ``_ct_res_only``)."""
    def predictor(x):
        return model(x.to(model.dtype), res_only=True)

    return SlidingWindowEngine(predictor, roi, sw_batch_size=sw, overlap=overlap)


def make_volume(seed: int, shape=VOLUME_SHAPE, device="cuda") -> torch.Tensor:
    """(1, X, Y, Z, 1) fp32 standard-normal volume from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    return torch.randn((1, *shape, 1), generator=gen, device=device)


def segment(engine: SlidingWindowEngine, volume: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blended logits (1, X, Y, Z, C) fp32 and the argmax mask (1, X, Y, Z)."""
    with torch.inference_mode():
        (logits,) = engine(volume)
        mask = logits.argmax(-1).to(torch.int32)
    return logits, mask


def ensemble(res_map: torch.Tensor, tu_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ensemble of ``bench.py``/test_CTUNet_final.py: fp32 softmax of each
    blended map, their mean, argmax. Returns (probabilities, int32 mask)."""
    prob = (torch.softmax(res_map.float(), -1) + torch.softmax(tu_map.float(), -1)) / 2.0
    return prob, prob.argmax(-1).to(torch.int32)


def segment_hybrid(ct_engine: SlidingWindowEngine, tu_engine: SlidingWindowEngine,
                   volume: torch.Tensor):
    """(res map, TUNet map, ensemble probabilities, mask) of one volume."""
    with torch.inference_mode():
        (res_map,) = ct_engine(volume)
        (tu_map,) = tu_engine(volume)
        prob, mask = ensemble(res_map, tu_map)
    return res_map, tu_map, prob, mask
