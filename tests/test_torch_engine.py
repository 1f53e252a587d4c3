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
)
from hybrid_ctunet_tpu.infer import sliding_window as j_sw

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


def test_engine_rejects_bad_volume():
    engine = SlidingWindowEngine(lambda x: x, (8, 8, 8))
    with pytest.raises(ValueError):
        engine(torch.zeros(2, 8, 8, 8, 1))
