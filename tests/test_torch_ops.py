"""Port ops against the JAX package's (CPU, fp32): SAME padding, conv,
instance/layer norm, activations, gaussian importance map."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.ops import act as j_act
from hybrid_ctunet_tpu.ops import conv as j_conv
from hybrid_ctunet_tpu.ops import norm as j_norm
from hybrid_ctunet_tpu.ops.importance import gaussian_importance_map as j_importance
from hybrid_ctunet_tpu_torch.ops import act, conv, norm
from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map


@pytest.mark.parametrize("k,s", [(3, 1), (1, 1), (3, 2), (1, 2), (7, (2, 2, 1)),
                                 ((3, 3, 1), (2, 2, 1)), (2, 2), (4, 2)])
def test_same_padding_matches(k, s):
    assert conv.same_padding(k, s) == j_conv.same_padding(k, s)


def test_same_padding_rejects_negative():
    with pytest.raises(ValueError):
        conv.same_padding(1, 3)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, (2, 2, 1)])
def test_conv3d_same_matches_jax(rng, k, stride):
    x = rng.standard_normal((2, 9, 8, 7, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, k, 3, 5)).astype(np.float32)  # DHWIO
    want = np.asarray(j_conv.conv3d_same(jnp.asarray(x), jnp.asarray(w), stride))
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    got = conv.conv3d_same(torch.from_numpy(x), w_t, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_instance_norm_matches_jax(rng):
    x = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32)
    want = np.asarray(j_norm.instance_norm(jnp.asarray(x)))
    got = norm.instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want = np.asarray(j_norm.instance_norm_leaky(jnp.asarray(x)))
    got = norm.instance_norm_leaky(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_instance_norm_large_mean_matches_jax(rng):
    """|mean| = 20 std: both use the single-pass E[x^2] - E[x]^2 form, which
    cancels ~log2(mean^2/var) ~ 9 bits of fp32; the two packages sum in
    different orders, so the normalized values agree to ~2^-14, not 1e-5."""
    x = (20.0 + rng.standard_normal((2, 6, 5, 4, 3))).astype(np.float32)
    want = np.asarray(j_norm.instance_norm(jnp.asarray(x)))
    got = norm.instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    # and the form is the clamped single-pass one: a constant channel gives 0
    x[..., 0] = 37.0
    got = norm.instance_norm(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and np.abs(got[..., 0]).max() < 1e-2


def test_layer_norm_matches_jax(rng):
    x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(j_norm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = norm.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_activations_match_jax(rng):
    x = rng.standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(
        act.gelu_exact(torch.from_numpy(x)).numpy(),
        np.asarray(j_act.gelu_exact(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        act.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(j_act.leaky_relu(jnp.asarray(x))), atol=0, rtol=0)


@pytest.mark.parametrize("size,sigma", [((96, 96, 96), 0.125), ((32, 32, 32), 0.125),
                                        ((7, 9, 11), 0.125), ((16, 24, 8), (0.1, 0.2, 0.3))])
def test_gaussian_importance_map_equal(size, sigma):
    got = gaussian_importance_map(size, sigma)
    want = j_importance(size, sigma)
    assert got.dtype == np.float32 and got.shape == tuple(size)
    np.testing.assert_array_equal(got, want)
