"""TUNet of the port against the JAX TUNet: weights carried across in both
directions, fp32 forward parity at the TINY size, the full-width parameter
count, and the pf 16 rejection."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.models import TUNet as JTUNet
from hybrid_ctunet_tpu.utils.torch_import import convert_tunet
from hybrid_ctunet_tpu_torch.models import TUNet
from hybrid_ctunet_tpu_torch.utils.params import (
    load_numpy_state_dict, random_init_, tunet_state_dict_from_jax,
)

# tests/test_models.py TINY
TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
REF_TUNET_PF8 = 109_904_124


def _random_leaf(rng, path, shape):
    """Random values with the JAX package's init scales: kernels N(0, 1/fan_in)
    (2/fan_in for convs), LN scales 1 + noise, biases small, tables N(0, 1)."""
    name = path[-1].key
    if name == "kernel":
        fan_in = int(np.prod(shape[-4:-1])) if len(shape) == 5 else shape[-2]
        std = np.sqrt((2.0 if len(shape) == 5 else 1.0) / fan_in)
    elif name in ("pos_embedding", "rel_pos_bias"):
        std = 1.0
    else:
        std = 0.1
    v = rng.standard_normal(shape) * std + (1.0 if name == "scale" else 0.0)
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX TINY TUNet's parameter tree (shapes from ``init`` under
    eval_shape, values from numpy) and an input."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    model = JTUNet(**TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _random_leaf(rng, path, s.shape), shapes)
    return model, params, x


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_jax_tree_round_trip(jax_tiny):
    """JAX tree -> port state dict -> convert_tunet -> the same JAX tree,
    every leaf consumed; the state dict loads strictly into the port."""
    _, params, _ = jax_tiny
    sd = tunet_state_dict_from_jax({"params": params})
    assert set(sd) == set(TUNet(**TINY, device="meta").state_dict())
    back = _leaves(convert_tunet(sd, depth=TINY["num_depths"])["params"])
    want = _leaves(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_port_state_dict_round_trip():
    """port state dict -> convert_tunet -> tunet_state_dict_from_jax -> the
    same state dict, every key consumed."""
    model = random_init_(TUNet(**TINY), seed=5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = tunet_state_dict_from_jax(convert_tunet(sd, depth=TINY["num_depths"]))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_tiny_tunet_matches_jax_fp32(jax_tiny):
    """fp32 forward, converted weights. atol/rtol 1e-4: the JAX CPU path
    still runs its z-fold (FOLD96/altfold) conv rewrites, which reorder the
    conv sums, and the port concatenates where JAX splits the conv."""
    jm, params, x = jax_tiny
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    model = TUNet(**TINY)
    load_numpy_state_dict(model, tunet_state_dict_from_jax({"params": params}))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 32, 32, 32, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_full_width_param_count_on_meta():
    model = TUNet(out_channels=14, patch_frame=8, device="meta")
    assert sum(p.numel() for p in model.parameters()) == REF_TUNET_PF8
    assert all(p.is_meta for p in model.parameters())


def test_patch_frame_16_rejected():
    with pytest.raises(ValueError, match="patch_frame"):
        TUNet(out_channels=14, patch_frame=16, device="meta")
