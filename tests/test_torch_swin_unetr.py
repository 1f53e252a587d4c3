"""Swin-UNETR on the port (``models/swin_unetr.py``) against its plain float32
reference (``reference/swin_unetr.py``) on the CPU, where every kernel
wrapper takes its plain version; the two references (the repo's and the
benchmark's frozen copy) against each other; the shift mask and the
stage-4 bias index against a transcription of MONAI's; the model on the
normal path (``build_model``, ``make_engine``, the train step).

The small size, feature size 12 at a 64^3 ROI, keeps every quirk of the
BTCV model: padding 32 -> 35, 16 -> 21 and 8 -> 14, shifted blocks at
stages 1-3, and stage 4's 4^3 map clamping the window to 4^3 with the 7^3
index sliced to its 64 tokens."""
import argparse

import pytest
import torch

from benchmark import weights
from benchmark.reference import models as bench_models
from benchmark.reference import swin_unetr as bench_swin
from hybrid_ctunet_tpu_torch.cli.bench import make_engine
from hybrid_ctunet_tpu_torch.cli.factory import build_model
from hybrid_ctunet_tpu_torch.models import SwinUNETR
from hybrid_ctunet_tpu_torch.ops import attention
from hybrid_ctunet_tpu_torch.ops.losses import dice_ce_loss
from hybrid_ctunet_tpu_torch.reference import swin_unetr as ref
from hybrid_ctunet_tpu_torch.train import steps

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

FS, ROI, CLASSES = 12, 64, 3
SIZES = dict(in_channels=1, out_channels=CLASSES, feature_size=FS, depths=[2, 2, 2, 2],
             num_heads=[3, 6, 12, 24], window_size=7, mlp_ratio=4.0)


def _state(model, seed=11):
    """The benchmark's seeded weights: nonzero biases and LayerNorm shifts,
    so that a dropped one shows."""
    return weights.make([(n, tuple(p.shape)) for n, p in model.named_parameters()], seed, "cpu")


def _input(batch=1, size=ROI, seed=0):
    return torch.randn(batch, size, size, size, 1, generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.fixture(scope="module")
def step_fp32():
    """One DiceCE step's forward and gradients, port and reference, fp32."""
    reference = ref.SwinUNETR(out_channels=CLASSES, feature_size=FS)
    port = SwinUNETR(img_size=(ROI,) * 3, out_channels=CLASSES, feature_size=FS)
    sd = _state(reference)
    reference.load_state_dict(sd)
    port.load_state_dict(sd)
    x = _input()
    y = torch.randint(0, CLASSES, (1, ROI, ROI, ROI), generator=torch.Generator().manual_seed(1))
    out = {}
    for name, model in (("reference", reference), ("port", port)):
        (logits,) = model(x)
        dice_ce_loss(logits, y).backward()
        out[name] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    return x, sd, out


def test_forward_matches_the_reference_fp32(step_fp32):
    """fp32 within 1e-5 relative: the same products in another order (the
    port's window partition and K2's plain core against MONAI's reshapes)."""
    _, _, out = step_fp32
    got, want = out["port"][0], out["reference"][0]
    assert got.shape == (1, ROI, ROI, ROI, CLASSES)
    assert _rel(got, want) <= 1e-5


def test_gradients_match_the_reference(step_fp32):
    """Every parameter's gradient of one DiceCE step within 1e-4 of the
    reference's norm, relative (the loss's softmax and the norms'
    reductions differentiate sums taken in another order; 9e-6 at worst on
    this seed). A gradient that is zero but for rounding is held to 1e-4 of
    a thousandth of the whole gradient's norm instead: encoder1's projection
    is a 1^3 conv of the one input channel, whose InstanceNorm leaves the
    loss blind to its scale (its gradient's norm is 3e-6 of the whole's)."""
    _, _, out = step_fp32
    got, want = out["port"][1], out["reference"][1]
    assert set(got) == set(want)
    total = torch.cat([g.flatten() for g in want.values()]).norm().item()
    for n in want:
        gap = (got[n] - want[n]).norm().item()
        assert gap <= 1e-4 * max(want[n].norm().item(), 1e-3 * total), n


def test_forward_bf16(step_fp32):
    """The bf16 port against the fp32 reference: relative L2 within 0.03
    (activations rounded to bf16 through 8 transformer blocks and 10 conv
    blocks; 0.008 on this seed)."""
    x, sd, out = step_fp32
    port = SwinUNETR(img_size=(ROI,) * 3, out_channels=CLASSES, feature_size=FS,
                     dtype=torch.bfloat16)
    port.load_state_dict(sd)
    with torch.no_grad():
        (got,) = port(x)
    assert got.dtype == torch.bfloat16
    assert _rel(got, out["reference"][0]) <= 0.03


def test_the_two_references_agree_exactly(step_fp32):
    """The benchmark's frozen copy with plain float32 arithmetic computes the
    repo reference's logits bit for bit, and records its sites: 26
    InstanceNorms and 8 window attentions."""
    x, sd, out = step_fp32
    ar = bench_models.Arith()
    frozen = bench_swin.build(SIZES, ar)
    frozen.load_state_dict(sd)
    ar.recording = True
    with torch.no_grad():
        got = frozen(x)
    assert torch.equal(got, out["reference"][0])
    assert len(ar.norm_sites) == 26
    assert ar.attn_sites == [(125, 3, 343, 4)] * 2 + [(27, 6, 343, 4)] * 2 \
        + [(8, 12, 343, 4)] * 2 + [(1, 24, 64, 4)] * 2


def test_parameters_at_the_btcv_widths():
    """62,187,296 parameters at feature size 48 (the published 62.2 M), MONAI's
    keys, and a MONAI state dict's ``relative_position_index`` buffers taken
    and dropped on load."""
    model = SwinUNETR(device="meta")
    assert sum(p.numel() for p in model.parameters()) == 62_187_296
    keys = set(model.state_dict())
    for k in ("swinViT.patch_embed.proj.weight", "swinViT.layers4.0.downsample.reduction.weight",
              "swinViT.layers1.0.blocks.1.attn.relative_position_bias_table",
              "swinViT.layers1.0.blocks.0.mlp.linear2.bias", "encoder1.layer.conv3.conv.weight",
              "encoder10.layer.conv2.conv.weight", "decoder5.transp_conv.conv.weight",
              "decoder1.conv_block.conv1.conv.weight", "out.conv.conv.bias"):
        assert k in keys, k
    small = SwinUNETR(img_size=(32,) * 3, out_channels=CLASSES, feature_size=FS)
    sd = {k: v.clone() for k, v in _state(small).items()}
    sd["swinViT.layers2.0.blocks.0.attn.relative_position_index"] = ref.relative_position_index(7)
    small.load_state_dict(sd)  # strict: every key known


@pytest.mark.parametrize("padded,window,shift", [((35, 35, 35), 7, 3), ((21, 21, 21), 7, 3),
                                                 ((14, 14, 14), 7, 3), ((49, 49, 49), 7, 3),
                                                 ((14, 21, 7), 7, 3)])
def test_shift_mask_is_monai_compute_mask(padded, window, shift):
    got = attention.shift_mask(padded, window, shift)
    assert torch.equal(got, ref.compute_mask(padded, (window,) * 3, (shift,) * 3))


def test_shift_mask_with_an_unshifted_axis():
    """An axis no larger than the window is not shifted: one region there."""
    got = attention.shift_mask((14, 14, 4), (7, 7, 4), (3, 3, 0))
    assert torch.equal(got, ref.compute_mask((14, 14, 4), (7, 7, 4), (3, 3, 0)))


@pytest.mark.parametrize("window", [7, 6, 4, 3])
def test_bias_index_is_monai_sliced_index(window):
    """The 7^3 index sliced to a clamped window's tokens (MONAI's
    ``relative_position_index[:n, :n]``), as K2 computes it."""
    n = window ** 3
    want = ref.relative_position_index(7)[:n, :n]
    assert torch.equal(attention.rel_pos_index(window, None, 7), want)


def test_normal_path_builds_serves_and_trains():
    """``build_model`` makes it from ``--model_name swin_unetr``, the
    single-output engine serves it unchanged, and the DiceCE train step
    takes a step on its one output."""
    args = argparse.Namespace(
        model_name="swin_unetr", out_channels=CLASSES, in_channels=1, norm_name="instance",
        noamp=True, roi_x=32, roi_y=32, roi_z=32, patch_frame=8, hidden_size=64, num_depths=1,
        mlp_dim=64, num_heads=2, feature_size=FS, window=2, dropout_rate=0.0, distributed=False,
        world_size=1)
    model = build_model(args, torch.device("cpu"))
    assert isinstance(model, SwinUNETR)
    model.eval()
    volume = _input(size=40)[:, :, :36]
    (blended,) = make_engine(model, (32, 32, 32), 0.5, 2)(volume)
    assert blended.shape == (1, 40, 36, 40, CLASSES) and torch.isfinite(blended).all()
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    label = torch.randint(0, CLASSES, (2, 32, 32, 32, 1), generator=torch.Generator().manual_seed(3))
    metrics = steps.make_train_step("swin_unetr", model, opt)(_input(2, 32), label, 1e-4)
    assert torch.isfinite(metrics["loss"])
    (logits,) = model(_input(2, 32))
    assert steps.LOSS_FNS["swin_unetr"]((logits,), label)[0].item() == pytest.approx(
        dice_ce_loss(logits, label).item())
