"""The benchmark's reference against the program, on the CPU: the same state
dict, the same parameter names, FLOP counts equal to the program's
``utils/flops.py``, and at a small width the same outputs, losses and
gradients as the program's plain path. Only these tests import both."""
from __future__ import annotations

import bench_tiny
import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import cost, data, models, window
from benchmark.reference import train as ref_train
from hybrid_ctunet_tpu_torch.data import transforms
from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine
from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet
from hybrid_ctunet_tpu_torch.models.layers import remat_blocks
from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map
from hybrid_ctunet_tpu_torch.ops.losses import dice_ce_loss
from hybrid_ctunet_tpu_torch.ops.resize import downscale_labels
from hybrid_ctunet_tpu_torch.train.state import make_optimizer
from hybrid_ctunet_tpu_torch.train.steps import make_train_step
from hybrid_ctunet_tpu_torch.utils import flops

FULL = harness.load_json("configs", "hybrid_ensemble")["model"]


def _program(kind, m, dtype=torch.float32, device="cpu"):
    tunet = dict(img_size=tuple(m["roi"][:2]), frames=m["roi"][2], patch_frame=m["patch_frame"],
                 hidden_size=m["hidden_size"], num_depths=m["num_depths"], mlp_dim=m["mlp_dim"],
                 num_heads=m["num_heads"], window=m["window"], dim_conv_stem=m["feature_size"])
    if kind == "ctunet":
        return CTUNet(out_channels=m["out_channels"], model_depth=m["model_depth"],
                      in_channels=m["in_channels"], dtype=dtype, device=device, **tunet)
    return TUNet(out_channels=m["out_channels"], in_channels=m["in_channels"], dtype=dtype,
                 device=device, **tunet)


@pytest.mark.parametrize("kind,res_only", [("ctunet", True), ("ctunet", False), ("tunet", False)])
def test_flops_equal_the_programs_count(kind, res_only):
    got, sites = cost.forward_cost(kind, FULL, 1, res_only)
    want = flops.count_model_flops(_program(kind, FULL, torch.bfloat16, "meta"), 1,
                                   res_only=res_only)
    assert got == sum(want.values())
    assert len(sites) == {("ctunet", True): 118, ("ctunet", False): 124, ("tunet", False): 6}[
        (kind, res_only)]


def test_hybrid_volume_is_296_436_tflop():
    ct, _ = cost.forward_cost("ctunet", FULL, 1, True)
    tu, _ = cost.forward_cost("tunet", FULL, 1, False)
    n_ct = len(window.window_starts((256, 256, 128), FULL["roi"], 0.5))
    n_tu = len(window.window_starts((256, 256, 128), FULL["roi"], 0.7))
    assert (n_ct, n_tu) == (50, 147)
    assert round((ct * n_ct + tu * n_tu) / 1e12, 3) == 296.436


@pytest.mark.parametrize("kind", ["ctunet", "tunet"])
def test_same_state_dict_keys_and_shapes(kind):
    ref = models.build(kind, FULL, models.Arith(), "meta").state_dict()
    prog = _program(kind, FULL, torch.bfloat16, "meta").state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: tuple(v.shape)
                                                           for k, v in prog.items()}


def test_window_plan_and_importance_equal_the_programs():
    for image, roi, overlap in (((256, 256, 128), (96,) * 3, 0.5), ((256, 256, 128), (96,) * 3,
                                                                   0.7), ((48, 48, 40), (32,) * 3, 0.5)):
        eng = SlidingWindowEngine(lambda x: x, roi, overlap=overlap)
        assert np.array_equal(window.window_starts(image, roi, overlap), eng.plan(image)[3])
    assert np.array_equal(window.importance_map((96,) * 3), gaussian_importance_map((96,) * 3))


def _tiny_state(kind, seed=3):
    m = bench_tiny.TINY
    shapes = models.parameter_shapes(models.build(kind, m, models.Arith(), "meta"))
    return weights.make(shapes, seed, "cpu")


@pytest.mark.parametrize("kind", ["ctunet", "tunet"])
def test_forward_equals_the_programs_plain_path(kind):
    m = bench_tiny.TINY
    sd = _tiny_state(kind)
    ref = models.build(kind, m, models.Arith(), "cpu")
    ref.load_state_dict(sd)
    prog = _program(kind, m)
    prog.load_state_dict(sd)
    x = torch.rand((2, *m["roi"], 1), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = prog(x), ref(x)
    flat_got = [t for t in torch.utils._pytree.tree_leaves(got)]
    flat_want = [t for t in torch.utils._pytree.tree_leaves(want)]
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape
        assert float((g - w).norm() / w.norm()) < 1e-4
    with torch.no_grad():
        if kind == "ctunet":
            assert float((prog(x, res_only=True) - ref(x, res_only=True)).norm()) < 1e-3 * float(
                ref(x, res_only=True).norm())


def test_loss_and_zoom_equal_the_programs():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 16, 16, 8, 3), generator=g)
    labels = torch.randint(0, 3, (2, 16, 16, 8), generator=g)
    assert torch.allclose(ref_train.dice_ce(logits, labels), dice_ce_loss(logits, labels),
                          rtol=1e-6)
    for z in ((0.5, 0.5, 1.0), (0.25, 0.25, 0.5)):
        assert torch.equal(ref_train.zoom_nearest(labels, z), downscale_labels(labels, z))


def test_train_steps_equal_the_programs_plain_step():
    """Two float32 steps of the TINY CTUNet: the program's step (block remat
    off, the full batch at once) and the reference's (a crop at a time,
    AdamW written out) agree in losses, in the first gradient leaf by leaf,
    and in each leaf's change (AdamW's steps are sign-like where a gradient
    is near zero, so the changes are compared by the benchmark's leaf
    measure, not element by element)."""
    m = bench_tiny.TINY
    sd = _tiny_state("ctunet")
    g = torch.Generator().manual_seed(2)
    batches = [(torch.rand((4, *m["roi"], 1), generator=g),
                torch.randint(0, 3, (4, *m["roi"], 1), generator=g).to(torch.uint8))
               for _ in range(2)]
    prog = _program("ctunet", m)
    prog.load_state_dict(sd)
    prog.train()
    opt = make_optimizer(prog.parameters(), "adamw", reg_weight=1e-5)
    step = make_train_step("ctunet", prog, opt)
    losses = []
    with remat_blocks(False):
        for k, (x, y) in enumerate(batches):
            losses.append(float(step(x, y, 1e-4)["loss"]))
            if k == 0:
                grads = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in prog.named_parameters()}
    ref = models.build("ctunet", m, models.Arith(), "cpu")
    ref.load_state_dict(sd)
    ref.train()
    out = ref_train.train_steps(ref, batches, 1e-4, 1e-5)
    assert np.allclose(losses, out["losses"], rtol=1e-5)
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    assert drv.leaf_gap(grads, out["first_grads"]) < 5e-3  # C5: fp32 reordering at 32^3
    change = {n: p.detach() - sd[n] for n, p in prog.named_parameters()}
    assert drv.leaf_gap(change, {n: p - sd[n] for n, p in out["params"].items()}) < 2e-2


def test_crops_equal_the_programs_loader():
    """The reference's preprocessing, crops and augmentations equal the
    program's on the same case and draws."""
    rng_case = np.random.default_rng(4)
    img = rng_case.normal(40, 30, (48, 48, 40)).astype(np.float32)
    img[:3] = -900.0  # air the foreground crop removes
    lab = (rng_case.random((48, 48, 40)) < 0.1).astype(np.uint8) * 2
    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    inten = dict(a_min=-175.0, a_max=250.0, b_min=0.0, b_max=1.0)
    pi, pl, _ = transforms.preprocess_case(img, affine, lab, pixdim=(1.5, 1.5, 2.0), **inten)
    ri, rl = data.preprocess(img, lab, affine, (1.5, 1.5, 2.0), **inten)
    assert np.array_equal(pi, ri) and np.array_equal(pl, rl)
    probs = {"RandFlipd_prob": 0.5, "RandRotate90d_prob": 0.5, "RandScaleIntensityd_prob": 0.5,
             "RandShiftIntensityd_prob": 0.5}
    for key in range(6):
        a = transforms.rand_crop_by_pos_neg_label(pi, pl, np.random.default_rng(key),
                                                  spatial_size=(32, 32, 32), num_samples=4)
        rng = np.random.default_rng(key)
        b = data.crops(ri, rl, rng, (32, 32, 32), 4)
        rng_a = np.random.default_rng(key)
        transforms.rand_crop_by_pos_neg_label(pi, pl, rng_a, spatial_size=(32, 32, 32),
                                              num_samples=4)
        for (ai, al), (bi, bl) in zip(a, b):
            ai2, al2 = transforms.augment_crop(ai, al, rng_a, probs)
            bi2, bl2 = data.augment(bi, bl, rng, probs)
            assert np.array_equal(ai2, bi2) and np.array_equal(al2, bl2)
