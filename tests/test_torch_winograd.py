"""K9's plain version (the F(2,3)^3 conv of ops/winograd.py) and its fused
form against the JAX package, fp32 at (1, 2, 32, 96, 32) as
tests/test_pallas_ops.py pins the Pallas kernel (atol 2e-4: the transforms
are exact binary fractions, so only the fp32 summation order differs), with
gradients through the direct conv; the port's gate against the JAX gate's
cases; the autograd rule the kernel wrappers share (ops/recompute.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.ops import winograd as jw
from hybrid_ctunet_tpu.ops import winograd_pallas as wp
from hybrid_ctunet_tpu_torch.ops import conv as conv_ops
from hybrid_ctunet_tpu_torch.ops import winograd
from hybrid_ctunet_tpu_torch.ops.recompute import recompute

SHAPE = (1, 2, 32, 96, 32)
TOL = dict(atol=2e-4, rtol=2e-4)


def _torch_w(w_dhwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_dhwio.transpose(4, 3, 0, 1, 2)))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 32, 32)) * 0.1).astype(np.float32)
    return x, w


def test_transform_filter_matches_jax(case):
    _, w = case
    got = winograd.transform_filter(_torch_w(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jw.transform_filter(jnp.asarray(w))), atol=1e-6)


def test_plain_matches_jax_reference_with_grads(case):
    """The plain version (fp32) equals ``conv3x3_winograd_reference``; the
    wrapper's gradients equal the JAX kernel's custom VJP (its direct
    conv's)."""
    x, w = case
    want = np.asarray(jw.conv3x3_winograd_reference(jnp.asarray(x), jnp.asarray(w)))
    got = winograd.reference_conv3x3_winograd(torch.from_numpy(x), _torch_w(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    xt = torch.from_numpy(x).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    y = winograd.conv3x3_winograd(xt, wt)
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    y.square().sum().backward()

    def jloss(xx, ww):  # the JAX kernel's VJP: through its direct conv
        return jnp.sum(wp._direct_conv(xx, ww, jnp.float32) ** 2)

    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw).transpose(4, 3, 0, 1, 2),
                               atol=1e-3, rtol=1e-3)


def test_fused_matches_jax_fused_ref_with_grads(case):
    """Affine + LeakyReLU in, sums out: against ``winograd_pallas._fused_ref``,
    and gradients through y and both sums as the JAX fused VJP gives them."""
    x1, w = case
    rng = np.random.default_rng(1)
    x = np.concatenate([x1, rng.standard_normal(SHAPE).astype(np.float32)])
    scale = (1.0 + 0.1 * rng.standard_normal((2, 32))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((2, 32))).astype(np.float32)
    n = SHAPE[1] * SHAPE[2] * SHAPE[3]
    want = wp._fused_ref(*map(jnp.asarray, (x, w, scale, bias)), jnp.float32, True, True)

    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    y, s1, s2 = winograd.conv3x3_winograd_fused(xt, _torch_w(w), (st, torch.from_numpy(bias)),
                                                in_act=True, emit_stats=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(s1.detach().numpy() / n, np.asarray(want[1]) / n, atol=2e-4)
    np.testing.assert_allclose(s2.detach().numpy() / n, np.asarray(want[2]) / n, atol=2e-3)
    plain = winograd.reference_conv3x3_winograd_fused(
        xt.detach(), _torch_w(w), st.detach(), torch.from_numpy(bias), True, True)
    for g, p in zip((y, s1, s2), plain):
        torch.testing.assert_close(g.detach(), p)

    (y.square().sum() + (s1 * s2).sum() / n).backward()

    def jloss(xx, sc):  # the JAX fused VJP: through _fused_ref
        yy, a, b = wp._fused_ref(xx, jnp.asarray(w), sc, jnp.asarray(bias), jnp.float32, True,
                                 True)
        return jnp.sum(yy ** 2) + jnp.sum(a * b) / n

    gx, gs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), atol=1e-4, rtol=1e-4)


def test_bf16_plain_rounds_where_the_kernel_does(case):
    """In bf16 the plain version rounds U and V and the output, and stays
    within bf16 rounding of the fp32 conv."""
    x, w = case
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wt = _torch_w(w)
    got = winograd.reference_conv3x3_winograd(xb, wt)
    assert got.dtype == torch.bfloat16
    want = winograd.reference_conv3x3_winograd(xb.float(), wt)
    err = (got.float() - want).norm() / want.norm()
    assert 1e-4 < err.item() < 1e-2


@pytest.mark.parametrize("x_shape,w_shape,stride,ok", [
    ((1, 2, 32, 96, 32), (32, 32, 3, 3, 3), (1, 1, 1), True),
    ((1, 2, 32, 96, 32), (32, 32, 3, 3, 3), (2, 2, 2), False),
    ((1, 2, 32, 96, 32), (32, 32, 1, 1, 1), (1, 1, 1), False),
    ((1, 2, 32, 95, 32), (32, 32, 3, 3, 3), (1, 1, 1), False),
    ((1, 2, 32, 96, 48), (48, 48, 3, 3, 3), (1, 1, 1), False),
    ((1, 48, 48, 48, 128), (128, 128, 3, 3, 3), (1, 1, 1), False),
])
def test_gate_matches_jax(x_shape, w_shape, stride, ok):
    """``test_winograd_supports_gating``'s cases (the last is declined by the
    JAX M >= 768 rule, which the port drops, and by Cin here); the port's
    gate is bf16-only, like its other kernel gates."""
    jax_w = (*w_shape[2:], w_shape[1], w_shape[0])
    assert wp.supports(x_shape, jax_w, stride) == ok
    assert winograd.supports(x_shape, w_shape, stride, torch.bfloat16) == ok
    assert not winograd.supports(x_shape, w_shape, stride, torch.float32)


def test_conv3d_same_keeps_the_direct_conv_on_the_cpu(monkeypatch):
    """On the CPU conv3d_same runs the direct conv even where K9's gate
    admits the shape, as the JAX default does (the CUDA routing is checked
    in test_torch_cuda.py)."""
    calls = []
    monkeypatch.setattr(winograd, "conv3x3_winograd",
                        lambda x, w: calls.append(x.shape) or winograd.direct_conv3x3(x, w))
    x = torch.randn(1, 4, 4, 6, 32)
    w = torch.randn(64, 32, 3, 3, 3) * 0.05
    assert winograd.supports(x.shape, w.shape, (1, 1, 1), torch.bfloat16)
    for xx, ww in ((x, w), (x.bfloat16(), w.bfloat16())):
        got = conv_ops.conv3d_same(xx, ww)
        torch.testing.assert_close(got, winograd.direct_conv3x3(xx, ww), rtol=0, atol=0)
    assert calls == []


def test_recompute_gives_the_plain_gradients():
    """Forward from ``run``, gradients from ``plain`` on the saved inputs,
    for every input that needs one and every output the loss reads."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(5, 3, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    c = torch.randn(3, generator=gen)

    def plain(a, b, c):
        return a * b + c, (a.square()).sum(0)

    out = recompute(lambda a, b, c: (torch.zeros(5, 3), torch.zeros(3)), plain, a, b, c)
    assert all(float(o.detach().abs().sum()) == 0 for o in out)  # the forward is run's
    (out[0].sum() + 2 * out[1].sum()).backward()
    a2, b2 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    o1, o2 = plain(a2, b2, c)
    (o1.sum() + 2 * o2.sum()).backward()
    torch.testing.assert_close(a.grad, a2.grad)
    torch.testing.assert_close(b.grad, b2.grad)
