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


@pytest.mark.parametrize("k,s", [((2, 2, 2), (2, 2, 2)), ((2, 2, 1), (2, 2, 1)),
                                 ((3, 3, 3), (2, 2, 2)), ((3, 3, 1), (2, 2, 1))])
def test_conv_transpose3d_same_matches_jax(rng, k, s):
    """k == s takes the einsum/K6 GEMM path in both packages; k != s the
    general transposed conv with MONAI's padding and output padding."""
    x = rng.standard_normal((2, 5, 4, 3, 6)).astype(np.float32)
    w = rng.standard_normal((*k, 6, 4)).astype(np.float32)  # (k0, k1, k2, Cin, Cout)
    want = np.asarray(j_conv.conv_transpose3d_same(jnp.asarray(x), jnp.asarray(w), s))
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 4, 0, 1, 2)))  # (Cin, Cout, k..)
    got = conv.conv_transpose3d_same(torch.from_numpy(x), w_t, s).numpy()
    assert got.shape == want.shape == (2, 5 * s[0], 4 * s[1], 3 * s[2], 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 1), ((2, 2, 1), (2, 2, 1), 0)])
def test_transpose_output_padding_matches(k, s, p):
    assert conv.transpose_output_padding(k, s, p) == j_conv.transpose_output_padding(k, s, p)


@pytest.mark.parametrize("dt,tol", [("fp32", 1e-5), ("bf16", 2.0 ** -6)])
def test_pixelweight_matches_jax(rng, dt, tol):
    """Plain pixelweight against ``pixelweight_reference`` (fp32 1e-5; bf16:
    both round at the same points, but XLA may keep the bf16 blend's
    products in fp32 where torch rounds each, and sums in another order, so
    values sit an ulp or two apart: 2^-6 relative, plus 2^-6 of the max)."""
    from hybrid_ctunet_tpu.ops import pixelweight as j_pw
    from hybrid_ctunet_tpu_torch.ops import pixelweight

    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    C = 64
    x1, x2 = (rng.standard_normal((2, 3, 4, 5, C)).astype(np.float32) for _ in range(2))
    ln = [1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
          1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C)]
    wq1, wq2 = (rng.standard_normal((C, 3 * C)) / np.sqrt(C) for _ in range(2))
    wo = rng.standard_normal((C, C)) / np.sqrt(C)
    jp = j_pw.PixelweightParams(*(jnp.asarray(a, jnp.float32) for a in (*ln, wq1, wq2, wo)))
    want = np.asarray(j_pw.pixelweight_reference(
        jnp.asarray(x1, jdt), jnp.asarray(x2, jdt), jp, dtype=jdt).astype(jnp.float32))
    tp = [torch.tensor(np.asarray(a, np.float32)) for a in (*ln, wq1.T, wq2.T, wo.T)]
    got = pixelweight.pixelweight(torch.from_numpy(x1).to(tdt), torch.from_numpy(x2).to(tdt),
                                  tp, tdt).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=tol)


@pytest.mark.parametrize("act", [False, True])
def test_instance_norm_on_offset_activations(rng, act):
    """|mean| = 30 std, as after a conv with a large bias-like response (C4):
    the single-pass fp32 form cancels ~log2(900) ~ 10 bits of the variance
    in both packages, which sum 210 values in different orders, so the
    normalized values (|y| <= 4) agree to 4e-3, not 1e-5; and a constant
    channel gives 0, not NaN, because the variance is clamped."""
    x = (30.0 + rng.standard_normal((2, 7, 6, 5, 16))).astype(np.float32)
    x[1, ..., 3] = -81.0
    j_fn = j_norm.instance_norm_leaky if act else j_norm.instance_norm
    fn = norm.instance_norm_leaky if act else norm.instance_norm
    want = np.asarray(j_fn(jnp.asarray(x)))
    got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=0)
    assert np.isfinite(got).all() and np.abs(got[1, ..., 3]).max() < 1e-2
