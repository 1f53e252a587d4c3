"""ResNet3D, CUNet and CTUNet of the port against the JAX package's: weights
carried across in both directions with every key consumed, fp32 forward
parity at depth 50 on small volumes (CTUNet at the TINY ViT config of
tests/test_models.py), and the full-width parameter counts on the meta
device.

Tolerances. The JAX CPU path runs its z-fold rewrites (folded ResNet
stages, the space-to-depth stem, altfold ResBlocks, FOLD96), which reorder
the conv sums, and splits concat convs in two where the port concatenates.
Where that is all (the ViT heads, one fusion block alone) outputs agree to
1e-4, as for TUNet. The ResNet's deep stages normalize over few voxels at
32^3 (128 and 16 per channel in stages 3 and 4), so those fp32 reordering
differences grow about fourfold per stage (measured: 2e-6, 8e-6, 4e-5 and
1.2e-4 of the output's max over the four stages); what reads them (the
ResNet, CUNet and CTUNet res heads) is held to 1e-3 of the output's max
(DEEP_TOL), which a wrong weight layout or rounding point would exceed by
orders of magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.models import CTUNet as JCTUNet
from hybrid_ctunet_tpu.models import CUNet as JCUNet
from hybrid_ctunet_tpu.models.layers import Up2FusionBlock as JUp2FusionBlock
from hybrid_ctunet_tpu.models.resnet3d import ResNet3D as JResNet3D
from hybrid_ctunet_tpu.utils.torch_import import convert_ctunet, convert_cunet
from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, ResNet3D
from hybrid_ctunet_tpu_torch.models.layers import Up2FusionBlock
from hybrid_ctunet_tpu_torch.utils.params import (
    _Out, ctunet_state_dict_from_jax, cunet_state_dict_from_jax, load_numpy_state_dict,
    random_init_,
)

# tests/test_models.py TINY
TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
TOL = dict(atol=1e-4, rtol=1e-4)
DEEP_TOL = 1e-3


def _close_deep(got, want):
    np.testing.assert_allclose(got, want, atol=DEEP_TOL * np.abs(want).max(), rtol=DEEP_TOL)


def _random_leaf(rng, path, shape):
    """Random values at the JAX package's init scales: conv kernels
    N(0, 2/fan_in) (a leading depth axis of stacked blocks aside), Linear
    N(0, 1/fan_in), LN scales 1 + noise, biases small, tables N(0, 1)."""
    name = path[-1].key
    if name == "kernel":
        conv = len(shape) >= 5
        fan_in = int(np.prod(shape[-5:-1])) if conv else shape[-2]
        std = np.sqrt((2.0 if conv else 1.0) / fan_in)
    elif name in ("pos_embedding", "rel_pos_bias"):
        std = 1.0
    else:
        std = 0.1
    return (rng.standard_normal(shape) * std + (1.0 if name == "scale" else 0.0)).astype(np.float32)


def _jax_case(model, seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape), shapes)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    return params, x, jax.tree_util.tree_map(np.asarray, want)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _forward(model, x, **kw):
    with torch.inference_mode():
        return model(torch.from_numpy(x), **kw)


@pytest.fixture(scope="module")
def jax_ctunet():
    return _jax_case(JCTUNet(model_depth=50, **TINY), 11, (1, 32, 32, 32, 1))


@pytest.fixture(scope="module")
def jax_cunet():
    return _jax_case(JCUNet(out_channels=3, model_depth=50), 12, (1, 32, 32, 32, 1))


def test_resnet50_matches_jax_fp32():
    params, x, want = _jax_case(JResNet3D(model_depth=50), 13, (1, 32, 32, 32, 1))
    out = _Out()
    out.resnet("r", params)
    model = ResNet3D(50)
    load_numpy_state_dict(model, {k[2:]: v for k, v in out.sd.items()})
    got = _forward(model, x)
    assert [tuple(g.shape) for g in got] == [
        (1, 16, 16, 32, 128), (1, 8, 8, 16, 256), (1, 4, 4, 8, 512), (1, 2, 2, 4, 1024)]
    for g, w in zip(got, want):
        _close_deep(g.numpy(), w)


def test_fusion_block_matches_jax_fp32():
    """One Up2FusionBlock (both pixelweight fusions, the k == s transposed
    conv, two ResBlocks) at 1e-4."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1, 4, 4, 4, 256)).astype(np.float32)
    skips = [rng.standard_normal((1, 8, 8, 8, 128)).astype(np.float32) for _ in range(2)]
    jm = JUp2FusionBlock(128, (2, 2, 2))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, *skips)["params"]
    params = jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape), shapes)
    want = np.asarray(jm.apply({"params": params}, x, *skips))
    out = _Out()
    out.transp("d", params)
    for i in (1, 2):
        out.pixelweight(f"d.pixelweight_attention{i}", params[f"pixelweight_attention{i}"])
        out.resblock(f"d.up_addconv_block{i}", params[f"up_addconv_block{i}"])
    model = Up2FusionBlock(256, 128, (2, 2, 2))
    load_numpy_state_dict(model, {k[2:]: v for k, v in out.sd.items()})
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (x, *skips)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cunet50_matches_jax_fp32(jax_cunet):
    params, x, want = jax_cunet
    model = CUNet(out_channels=3, model_depth=50)
    load_numpy_state_dict(model, cunet_state_dict_from_jax({"params": params}))
    got = _forward(model, x)
    shapes = [(1, 32, 32, 32, 3), (1, 16, 16, 32, 3), (1, 8, 8, 16, 3)]
    for g, w, s in zip(got, want, shapes):
        assert tuple(g.shape) == s
        _close_deep(g.numpy(), w)


def test_cunet_weight_round_trips(jax_cunet):
    """JAX tree -> state dict -> convert_cunet -> the same tree, and a port
    state dict -> convert_cunet -> back; every key and leaf consumed."""
    params, _, _ = jax_cunet
    sd = cunet_state_dict_from_jax({"params": params})
    assert set(sd) == set(CUNet(out_channels=3, model_depth=50, device="meta").state_dict())
    _assert_trees_equal(convert_cunet(sd, model_depth=50)["params"], params)
    port = {k: v.numpy() for k, v in random_init_(CUNet(3, 50), seed=4).state_dict().items()}
    back = cunet_state_dict_from_jax(convert_cunet(port, model_depth=50))
    assert set(back) == set(port)
    for k in port:
        np.testing.assert_array_equal(back[k], port[k], err_msg=k)


def test_ctunet50_matches_jax_fp32(jax_ctunet):
    """All five outputs of the TINY CTUNet (depth 50, 32^3), and the
    ensemble's res-only forward equal to the full forward's res head."""
    params, x, want = jax_ctunet
    model = CTUNet(model_depth=50, **TINY)
    load_numpy_state_dict(model, ctunet_state_dict_from_jax({"params": params}))
    (res, res48, res24), (vit, vit96) = _forward(model, x)
    (w_res, w_res48, w_res24), (w_vit, w_vit96) = want
    shapes = [(1, 32, 32, 32, 3), (1, 16, 16, 32, 3), (1, 8, 8, 16, 3), (1, 32, 32, 32, 3),
              (1, 32, 32, 32, 3)]
    for g, w, s in zip((res, res48, res24, vit, vit96), (w_res, w_res48, w_res24, w_vit, w_vit96),
                       shapes):
        assert tuple(g.shape) == s
    for g, w in zip((res, res48, res24), (w_res, w_res48, w_res24)):
        _close_deep(g.numpy(), w)
    for g, w in zip((vit, vit96), (w_vit, w_vit96)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert torch.equal(_forward(model, x, res_only=True), res)


def test_ctunet_weight_round_trips(jax_ctunet):
    """The ViT branch moves from ``core`` to the top level and back; every
    key and leaf consumed both ways."""
    params, _, _ = jax_ctunet
    sd = ctunet_state_dict_from_jax({"params": params})
    assert set(sd) == set(CTUNet(model_depth=50, **TINY, device="meta").state_dict())
    assert "vit.pos_embedding" in sd and not any(k.startswith("core.") for k in sd)
    _assert_trees_equal(convert_ctunet(sd, model_depth=50, depth=TINY["num_depths"])["params"],
                        params)
    port = {k: v.numpy()
            for k, v in random_init_(CTUNet(model_depth=50, **TINY), seed=6).state_dict().items()}
    back = ctunet_state_dict_from_jax(
        convert_ctunet(port, model_depth=50, depth=TINY["num_depths"]))
    assert set(back) == set(port)
    for k in port:
        np.testing.assert_array_equal(back[k], port[k], err_msg=k)


@pytest.mark.parametrize("build,count", [
    (lambda: ResNet3D(101, device="meta"), 16_457_152),
    (lambda: CUNet(14, 101, device="meta"), 50_779_754),
    (lambda: CTUNet(14, 101, patch_frame=8, device="meta"), 174_109_542),
])
def test_full_width_param_counts_on_meta(build, count):
    """Reference counts less the dead ResBlock ``conv3``s (tests/test_models.py)."""
    model = build()
    assert sum(p.numel() for p in model.parameters()) == count
    assert all(p.is_meta for p in model.parameters())


def test_transp_conv_init_fan_in():
    """A transposed conv's weight (Cin, Cout, k, k, k) draws at the JAX
    package's fan-in k^3 * Cin, not Cout * k^3."""
    model = random_init_(CUNet(3, 50), seed=1)
    w = model.res_decoder3.transp_conv.conv.weight  # (1024, 512, 2, 2, 2)
    np.testing.assert_allclose(w.std().item(), np.sqrt(2.0 / (8 * 1024)), rtol=0.01)
