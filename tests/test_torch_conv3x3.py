"""K10's gate (``ops.conv3x3.supports``) against every conv site of the
reference models, recorded from forwards of the full-width models on the
meta device (shapes only, nothing computed). The kernel itself is checked
against its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import collections

import pytest
import torch

from hybrid_ctunet_tpu_torch import kernels
from hybrid_ctunet_tpu_torch.models import CTUNet, SwinUNETR, TUNet, layers, swin_unetr
from hybrid_ctunet_tpu_torch.ops import conv3x3

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

BF = torch.bfloat16
CHUNK, ROI = 4, (96, 96, 96)
CUDA = torch.device("cuda")

# Swin-UNETR's stride-1 3^3 convs to 48 channels at ROI 96^3, a 4-window
# chunk: (x shape, w shape) -> calls a forward
SWIN_SITES = {
    ((4, 96, 96, 96, 1), (48, 1, 3, 3, 3)): 1,     # encoder1.conv1
    ((4, 96, 96, 96, 48), (48, 48, 3, 3, 3)): 2,   # encoder1.conv2, decoder1 conv2
    ((4, 96, 96, 96, 96), (48, 96, 3, 3, 3)): 1,   # decoder1 conv1
    ((4, 48, 48, 48, 48), (48, 48, 3, 3, 3)): 3,   # encoder2 conv1, conv2; decoder2 conv2
    ((4, 48, 48, 48, 96), (48, 96, 3, 3, 3)): 1,   # decoder2 conv1
}


def _conv_sites(model, **kw):
    """(x shape, w shape, stride) -> calls of ``conv3d_same`` in one eval
    forward of ``model`` on a meta chunk at ROI 96^3."""
    sites = collections.Counter()
    orig = layers.conv3d_same

    def rec(x, w, stride=1):
        sites[(tuple(x.shape), tuple(w.shape), layers._triple(stride))] += 1
        return orig(x, w, stride)

    layers.conv3d_same = swin_unetr.conv3d_same = rec
    try:
        with torch.no_grad():
            model.eval()(torch.empty(CHUNK, *ROI, 1, device="meta"), **kw)
    finally:
        layers.conv3d_same = swin_unetr.conv3d_same = orig
    return sites


@pytest.fixture(scope="module")
def census():
    return {
        "swin": _conv_sites(SwinUNETR(dtype=BF, device="meta")),
        "ctunet": _conv_sites(CTUNet(model_depth=101, patch_frame=8, dtype=BF, device="meta")),
        "ctunet_res": _conv_sites(CTUNet(model_depth=101, patch_frame=8, dtype=BF,
                                         device="meta"), res_only=True),
        "tunet": _conv_sites(TUNet(patch_frame=8, dtype=BF, device="meta")),
    }


def _admitted(sites, dtype=BF, device=CUDA):
    return {(x, w): n for (x, w, s), n in sites.items()
            if conv3x3.supports(x, w, s, dtype, device)}


def test_gate_admits_exactly_the_swin_sites_and_no_hybrid_site(census):
    """The eight Swin-UNETR convs at 96^3 and 48^3 (C 1, 48, 96 -> 48), no
    other Swin-UNETR conv, and none of the CTUNet's (whole and res-only) or
    the TUNet's; fp32, a CPU device, stride 2 and 1^3 kernels declined, and
    ``gates_off`` turns the gate off."""
    assert _admitted(census["swin"]) == SWIN_SITES
    assert sum(SWIN_SITES.values()) == 8
    for name in ("ctunet", "ctunet_res", "tunet"):
        assert census[name] and not _admitted(census[name]), name
    x, w = (4, 48, 48, 48, 48), (48, 48, 3, 3, 3)
    assert conv3x3.supports(x, w, (1, 1, 1), BF, CUDA)
    assert not conv3x3.supports(x, w, (1, 1, 1), torch.float32, CUDA)
    assert not conv3x3.supports(x, w, (1, 1, 1), BF, torch.device("cpu"))
    assert not conv3x3.supports(x, w, (2, 2, 2), BF, CUDA)
    assert not conv3x3.supports(x, (48, 48, 1, 1, 1), (1, 1, 1), BF, CUDA)
    assert not conv3x3.supports((4, 48, 48, 48, 32), (48, 32, 3, 3, 3), (1, 1, 1), BF, CUDA)
    assert not conv3x3.supports((4, 48, 48, 48, 48), (64, 48, 3, 3, 3), (1, 1, 1), BF, CUDA)
    with kernels.gates_off():
        assert not _admitted(census["swin"])
    assert _admitted(census["swin"]) == SWIN_SITES


def test_cpu_tensors_take_the_direct_conv():
    """On the CPU the wrapper is the direct conv, gradients included, and
    launches nothing."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 7, 9, 48, generator=gen).requires_grad_()
    w = (torch.randn(48, 48, 3, 3, 3, generator=gen) * 0.05).requires_grad_()
    before = conv3x3.conv3x3.launches
    got = conv3x3.conv3x3(x, w)
    want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    assert torch.equal(got, want.permute(0, 2, 3, 4, 1))
    gx, gw = torch.autograd.grad(got.square().sum(), (x, w))
    wx, ww = torch.autograd.grad(want.square().sum(), (x, w))
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    assert conv3x3.conv3x3.launches == before
