"""The port's SlidingWindowEngine against the JAX package's, with the same
fp32 predictor written in both frameworks: a fixed per-voxel linear map.

Tolerance rtol 1e-6, atol 1e-6: window grid, importance map, window order
and the blend arithmetic are the same; XLA may contract the predictor's
multiply-add into one FMA where torch rounds twice, one fp32 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.infer.sliding_window import SlidingWindowEngine as JEngine
from hybrid_ctunet_tpu.infer.sliding_window import _pad_amounts as j_pad_amounts
from hybrid_ctunet_tpu_torch.infer.sliding_window import (
    SlidingWindowEngine, _pad_amounts, dense_patch_starts, get_scan_interval,
    sliding_window_inference,
)
from hybrid_ctunet_tpu_torch.ops.resize import resample_3d_nearest
from hybrid_ctunet_tpu.infer import sliding_window as j_sw
from hybrid_ctunet_tpu.ops.resize import resample_3d_nearest as j_resample

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

W = np.array([[0.5, -1.25, 2.0]], np.float32)  # (C_in=1, 3)
B = np.array([0.25, -0.5, 1.0], np.float32)
W2 = np.array([[-0.75, 1.5]], np.float32)


def _jax_predictor(two):
    def pred(x):
        y = jnp.dot(x, jnp.asarray(W)) + jnp.asarray(B)
        return (y, jnp.dot(x, jnp.asarray(W2))) if two else y
    return pred


def _torch_predictor(two):
    def pred(x):
        y = torch.matmul(x, torch.from_numpy(W)) + torch.from_numpy(B)
        return (y, torch.matmul(x, torch.from_numpy(W2))) if two else y
    return pred


@pytest.mark.parametrize("size,overlap,sw,two", [
    ((70, 61, 45), 0.5, 4, False),
    ((70, 61, 45), 0.7, 4, True),    # 7 x 6 x 3 windows: a trailing chunk of 2
    ((20, 24, 28), 0.7, 3, False),   # smaller than the ROI: centred padding
    ((40, 32, 33), 0.25, 2, True),
])
def test_engine_matches_jax(rng, size, overlap, sw, two):
    roi = (32, 32, 32)
    vol = rng.standard_normal((1, *size, 1)).astype(np.float32)
    n_out = 2 if two else 1
    want = JEngine(_jax_predictor(two), roi, sw_batch_size=sw, overlap=overlap,
                   mode="gaussian", num_outputs=n_out)(jnp.asarray(vol))
    engine = SlidingWindowEngine(_torch_predictor(two), roi, sw_batch_size=sw,
                                 overlap=overlap, num_outputs=n_out)
    with torch.inference_mode():
        got = engine(torch.from_numpy(vol))
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (1, *size, w.shape[-1])
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,overlap", [((256, 256, 128), 0.7), ((70, 61, 45), 0.5),
                                          ((96, 96, 96), 0.7), ((20, 24, 28), 0.25)])
def test_window_grid_matches_jax(size, overlap):
    roi = (96, 96, 96) if size[0] > 90 else (32, 32, 32)
    lo, hi = _pad_amounts(size, roi)
    assert (lo, hi) == j_pad_amounts(size, roi)
    padded = tuple(s + a + b for s, a, b in zip(size, lo, hi))
    interval = get_scan_interval(padded, roi, overlap)
    assert interval == j_sw.get_scan_interval(padded, roi, overlap)
    np.testing.assert_array_equal(dense_patch_starts(padded, roi, interval),
                                  j_sw.dense_patch_starts(padded, roi, interval))
    if size == (256, 256, 128):  # the slice: 147 windows at interval 28
        assert interval == (28, 28, 28) and len(dense_patch_starts(padded, roi, interval)) == 147


@pytest.mark.parametrize("mode,sigma", [("constant", 0.125), ("gaussian", 0.25)])
def test_engine_blend_modes_match_jax(rng, mode, sigma):
    """``mode`` and ``sigma_scale`` (the JAX engine's :103-160): the
    constant blend, and a gaussian of another width."""
    roi, size = (32, 32, 32), (40, 32, 45)
    vol = rng.standard_normal((1, *size, 1)).astype(np.float32)
    want = JEngine(_jax_predictor(True), roi, sw_batch_size=4, overlap=0.5, mode=mode,
                   sigma_scale=sigma, num_outputs=2)(jnp.asarray(vol))
    engine = SlidingWindowEngine(_torch_predictor(True), roi, sw_batch_size=4, overlap=0.5,
                                 mode=mode, sigma_scale=sigma, num_outputs=2)
    with torch.inference_mode():
        got = engine(torch.from_numpy(vol))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        SlidingWindowEngine(_torch_predictor(False), roi, mode="triangle")


@pytest.mark.parametrize("two", [False, True])
def test_sliding_window_inference_matches_jax(rng, two):
    """The functional form at its defaults (constant blend, overlap 0.25):
    one map, or a tuple for a two-output predictor."""
    vol = rng.standard_normal((1, 40, 32, 33, 1)).astype(np.float32)
    want = j_sw.sliding_window_inference(jnp.asarray(vol), (32, 32, 32), 2, _jax_predictor(two))
    with torch.inference_mode():
        got = sliding_window_inference(torch.from_numpy(vol), (32, 32, 32), 2,
                                       _torch_predictor(two))
    got, want = (got, want) if two else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,target", [((9, 7, 5), (18, 3, 5)), ((96, 96, 96), (40, 41, 97))])
def test_resample_3d_nearest_matches_jax(shape, target):
    x = np.random.default_rng(2).integers(0, 14, shape).astype(np.int32)
    got = resample_3d_nearest(torch.from_numpy(x), target).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_resample(jnp.asarray(x), target)))


def test_engine_rejects_bad_volume():
    engine = SlidingWindowEngine(lambda x: x, (8, 8, 8))
    with pytest.raises(ValueError):
        engine(torch.zeros(2, 8, 8, 8, 1))


def test_hybrid_ensemble_matches_jax():
    """The ensemble at the TINY size (CTUNet depth 50 res-only at overlap 0.5,
    TUNet at 0.7, ROI 32^3, sw 2) on a (40, 36, 33) volume, 8 windows each.
    Port engines + ``cli.bench.ensemble`` against the JAX engines +
    ``bench.py``'s formula, the same weights in both (numpy, through the
    ``*_state_dict_from_jax`` inverses). Probabilities at 1e-4 (the fp32
    model forwards differ by the JAX z-fold sum orders, see
    test_torch_ctunet.py); the mask equal wherever the top two mean
    probabilities are more than 1e-4 apart."""
    import jax

    from hybrid_ctunet_tpu.models import CTUNet as JCTUNet
    from hybrid_ctunet_tpu.models import TUNet as JTUNet
    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet
    from hybrid_ctunet_tpu_torch.utils.params import (
        ctunet_state_dict_from_jax, load_numpy_state_dict, tunet_state_dict_from_jax,
    )
    from test_torch_ctunet import TINY, _random_leaf

    rng = np.random.default_rng(21)
    roi, size = (32, 32, 32), (40, 36, 33)
    vol = rng.standard_normal((1, *size, 1)).astype(np.float32)
    jct, jtu = JCTUNet(model_depth=50, **TINY), JTUNet(**TINY)
    patch = jnp.zeros((1, *roi, 1), jnp.float32)

    def leaves(m):
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), patch)["params"]
        return jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape), shapes)

    p_ct, p_tu = leaves(jct), leaves(jtu)
    jp_ct, jp_tu = (jax.tree_util.tree_map(jnp.asarray, p) for p in (p_ct, p_tu))

    def ct_fwd(x):
        (res, _, _), _ = jct.apply({"params": jp_ct}, x)
        return res

    def tu_fwd(x):
        return jtu.apply({"params": jp_tu}, x)[0]

    res_j = JEngine(ct_fwd, roi, sw_batch_size=2, overlap=0.5, mode="gaussian")(jnp.asarray(vol))
    tu_j = JEngine(tu_fwd, roi, sw_batch_size=2, overlap=0.7, mode="gaussian")(jnp.asarray(vol))
    res_j = res_j[0] if isinstance(res_j, (tuple, list)) else res_j
    tu_j = tu_j[0] if isinstance(tu_j, (tuple, list)) else tu_j
    prob_j = np.asarray((jax.nn.softmax(res_j, -1) + jax.nn.softmax(tu_j, -1)) / 2.0)
    mask_j = np.asarray(jnp.argmax(prob_j, -1).astype(jnp.int32))

    ct = CTUNet(model_depth=50, **TINY)
    load_numpy_state_dict(ct, ctunet_state_dict_from_jax({"params": p_ct}))
    tu = TUNet(**TINY)
    load_numpy_state_dict(tu, tunet_state_dict_from_jax({"params": p_tu}))
    ct_engine = bench.make_ctunet_engine(ct.eval(), roi=roi, sw=2)
    tu_engine = bench.make_engine(tu.eval(), roi=roi, sw=2)
    assert (len(ct_engine.plan(size)[3]), len(tu_engine.plan(size)[3])) == (8, 8)
    res, tu_map, prob, mask = bench.segment_hybrid(ct_engine, tu_engine, torch.from_numpy(vol))
    assert tuple(prob.shape) == (1, *size, 3) and mask.dtype == torch.int32
    np.testing.assert_allclose(prob.numpy(), prob_j, atol=1e-4, rtol=1e-4)
    top2 = np.sort(prob_j, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(mask.numpy()[clear], mask_j[clear])
