"""Each kernel module of the port (plain versions, as a CPU tensor takes them)
against the JAX package's function on the same inputs.

The JAX functions run as the JAX tests run them on CPU: their Pallas gates
need a TPU, so they take the plain reference paths. The CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``.

Tolerances: fp32 1e-5. bf16 results are compared in float32; the two
frameworks round at the same points, but sum in a different order inside the
matmuls, so a value may land one bf16 ulp apart (2^-8 relative, 2^-7 at the
bottom of a binade), and a flipped intermediate moves the next product:
rtol 2^-6 plus an atol of 2^-6 of the output's max magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.infer.sliding_window import dense_patch_starts, get_scan_interval
from hybrid_ctunet_tpu.models import layers as j_layers
from hybrid_ctunet_tpu.ops import attention_pallas, ffn_pallas, scatter_pallas, shuffle_pallas
from hybrid_ctunet_tpu_torch.models import layers
from hybrid_ctunet_tpu_torch.ops import attention, ffn, norm, pixelweight, scatter, shuffle
from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map
from hybrid_ctunet_tpu_torch.utils.params import _Out

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, dt):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dt == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        tol = 2.0 ** -6
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=tol)


def _jax_bias(table, window):
    """The JAX layer's gather: table[_rel_pos_indices(w)] -> (heads, T, T)."""
    return jnp.transpose(jnp.asarray(table)[j_layers._rel_pos_indices(window)], (2, 0, 1))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("n,window,heads", [(5, 3, 2), (3, 6, 1)])
def test_window_attention_core(rng, dt, n, window, heads):
    """K2's public entry (q, k, v, table, w) against the JAX layer's path: its
    gather of the table, then the attention oracle."""
    jdt, tdt = DTYPES[dt]
    c, t = heads * 32, window ** 3
    q, k, v = (rng.standard_normal((n, t, c)).astype(np.float32) for _ in range(3))
    q *= 32 ** -0.5
    table = rng.standard_normal(((2 * window - 1) ** 3, heads)).astype(np.float32)
    want = attention_pallas.reference_window_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), _jax_bias(table, window), jdt)
    got = attention.window_attention(*(_t(a, tdt) for a in (q, k, v)), _t(table), window, tdt)
    assert got.dtype == tdt
    _close(got, want, dt)


@pytest.mark.parametrize("window", [2, 3, 4, 5, 6])
def test_rel_pos_index_is_the_reference_gather(window):
    """The kernel's arithmetic index (row term + column term) equals the
    reference's relative-position index table."""
    np.testing.assert_array_equal(attention.rel_pos_index(window).numpy(),
                                  j_layers._rel_pos_indices(window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_table_is_gather_then_core(rng, dtype):
    """The table-form plain K2 equals the reference gather followed by the
    plain core, bit for bit."""
    window, heads, n = 3, 2, 4
    q, k, v = (_t(rng.standard_normal((n, 27, 64)), dtype) for _ in range(3))
    table = _t(rng.standard_normal((125, heads)))
    bias = table[torch.from_numpy(j_layers._rel_pos_indices(window).astype(np.int64))]
    want = attention.reference_window_attention(q, k, v, bias.permute(2, 0, 1), dtype)
    assert torch.equal(attention.window_attention(q, k, v, table, window, dtype), want)


def _window_attn_sd(p):
    out = _Out()
    out.window_attn("m", p)
    return {k[2:]: v for k, v in out.sd.items()}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("grid", [False, True])
def test_window_attention_layer(rng, dt, grid):
    """Block and grid partitions around the core; 2*2*3 = 12 windows of 2^3."""
    jdt, tdt = DTYPES[dt]
    x = rng.standard_normal((1, 4, 4, 6, 64)).astype(np.float32)
    jm = j_layers.MultiAxisWindowAttention(window=2, grid=grid, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x, jdt))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x, jdt))
    tm = layers.MultiAxisWindowAttention(64, window=2, grid=grid, dtype=tdt)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in _window_attn_sd(params).items()})
    with torch.inference_mode():
        got = tm(_t(x, tdt))
    _close(got, want, dt)


def _ffn_params(rng, c, h):
    return (1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
            rng.standard_normal((c, h)) / np.sqrt(c), 0.1 * rng.standard_normal(h),
            rng.standard_normal((h, c)) / np.sqrt(h), 0.1 * rng.standard_normal(c))


def _torch_ffn_params(p):
    """JAX layout (kernels (in, out)) -> torch Linear layout, fp32 tensors."""
    ln_w, ln_b, w1, b1, w2, b2 = p
    return (_t(ln_w), _t(ln_b), _t(np.asarray(w1).T), _t(b1), _t(np.asarray(w2).T), _t(b2))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ffn(rng, dt, residual):
    jdt, tdt = DTYPES[dt]
    x = rng.standard_normal((2, 3, 4, 5, 128)).astype(np.float32)
    p = _ffn_params(rng, 128, 512)
    jx = jnp.asarray(x, jdt)
    want = ffn_pallas.reference_ffn(jx, *(jnp.asarray(a, jnp.float32) for a in p), jdt)
    if residual:
        want = jx + want
    got = ffn.ffn(_t(x, tdt), *_torch_ffn_params(p), tdt, residual=residual)
    assert got.dtype == tdt
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_ffn_pair(rng, dt):
    """The pair against the JAX decoder's two residual FFNs (the path its
    stage 3 takes off the TPU)."""
    jdt, tdt = DTYPES[dt]
    x = rng.standard_normal((1, 4, 4, 6, 128)).astype(np.float32)
    p1, p2 = _ffn_params(rng, 128, 512), _ffn_params(rng, 128, 512)
    jx = jnp.asarray(x, jdt)
    y = jx + ffn_pallas.reference_ffn(jx, *(jnp.asarray(a, jnp.float32) for a in p1), jdt)
    want = y + ffn_pallas.reference_ffn(y, *(jnp.asarray(a, jnp.float32) for a in p2), jdt)
    got = ffn.ffn_pair(_t(x, tdt), _torch_ffn_params(p1), _torch_ffn_params(p2), tdt)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("factor,c,f", [((2, 2, 2), 64, 32), ((2, 2, 1), 128, 64)])
def test_pixel_shuffle(rng, dt, factor, c, f):
    jdt, tdt = DTYPES[dt]
    x = rng.standard_normal((2, 3, 4, 5, c)).astype(np.float32)
    cp = c // int(np.prod(factor))
    w = rng.standard_normal((cp, f)).astype(np.float32) / np.sqrt(cp)
    b = rng.standard_normal(f).astype(np.float32)
    want = shuffle_pallas.reference_shuffle(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b), factor, jdt)
    got = shuffle.pixel_shuffle_linear(_t(x, tdt), _t(w.T), _t(b), factor, tdt)
    assert got.shape == (2, 3 * factor[0], 4 * factor[1], 5 * factor[2], f)
    _close(got, want, dt)


@pytest.mark.parametrize("pred_dtype", ["fp32", "bf16"])
def test_scatter_bit_exact(rng, pred_dtype):
    """Unaligned window starts (overlap 0.7: interval int(20*0.3) = 6) into a
    (46, 33, 29) canvas, against the JAX package's XLA scatter on its
    merged-lane canvas (K = C+1 lanes, count map in lane C). Both multiply
    importance * prediction once and add windows in order: bit-exact."""
    C, roi = 3, (20, 16, 12)
    size = (46, 33, 29)
    starts = dense_patch_starts(size, roi, get_scan_interval(size, roi, 0.7))
    sel = starts[[1, 2, 9, 10, 11, 40]]
    imp = gaussian_importance_map(roi)
    pred = rng.standard_normal((len(sel), *roi, C)).astype(np.float32)
    if pred_dtype == "bf16":
        pred = np.asarray(jnp.asarray(pred, jnp.bfloat16).astype(jnp.float32))
    acc0 = rng.standard_normal((*size, C + 1)).astype(np.float32)

    contrib = np.concatenate(
        [imp[None, ..., None] * pred, np.broadcast_to(imp[None, ..., None], (len(sel), *roi, 1))],
        axis=-1,
    ).reshape(len(sel), roi[0], roi[1], roi[2] * (C + 1))
    s_scaled = sel * np.array([1, 1, C + 1], np.int32)
    want = scatter_pallas.scatter_add_windows(
        jnp.asarray(acc0.reshape(size[0], size[1], -1)), jnp.asarray(contrib),
        jnp.asarray(s_scaled), use_pallas=False,
    )
    want = np.asarray(want).reshape(*size, C + 1)

    tdt = DTYPES[pred_dtype][1]
    acc = torch.from_numpy(acc0.copy())
    out = scatter.scatter_add_windows(acc, _t(pred, tdt), torch.from_numpy(imp.copy()), sel)
    assert out is acc  # in place
    np.testing.assert_array_equal(acc.numpy(), want)


def test_scatter_rejects_window_outside_canvas():
    acc = torch.zeros(10, 10, 10, 2)
    with pytest.raises(ValueError):
        scatter.scatter_add_windows(acc, torch.zeros(1, 4, 4, 4, 1), torch.ones(4, 4, 4),
                                    [[0, 0, 7]])


def test_pair_and_transp_gates_take_the_main_path_sites():
    """The redesigned kernels' gates: K4 takes the stage-3 pair (C 128,
    hidden 512) in bf16; K6 every decoder upsample of CUNet / CTUNet."""
    bf = torch.bfloat16
    assert ffn.pair_supports(128, 512, bf)
    assert not ffn.pair_supports(256, 1024, bf)  # stage 2 runs as two K3 calls
    assert not ffn.pair_supports(128, 512, torch.float32)
    assert not ffn.pair_supports(128, 96, bf)  # not a whole number of 64-wide chunks
    for x, w in (((4, 6, 6, 12, 1024), (1024, 512, 2, 2, 2)),
                 ((4, 12, 12, 24, 512), (512, 256, 2, 2, 2)),
                 ((4, 24, 24, 48, 256), (256, 128, 2, 2, 2)),
                 ((4, 48, 48, 96, 128), (128, 64, 2, 2, 1))):
        assert shuffle.transp_supports(x, w, bf)
        assert not shuffle.transp_supports(x, w, torch.float32)
    assert not shuffle.transp_supports((1, 2, 2, 2, 96), (96, 64, 2, 2, 2), bf)  # Cin % 64
    assert not shuffle.transp_supports((1, 2, 2, 2, 128), (128, 4, 2, 2, 2), bf)  # Cout % 8


# every conv-path InstanceNorm site (X, Y, Z, C) of a CTUNet res-only chunk,
# a TUNet chunk and a CTUNet train step (recorded from forwards of the
# full-width models on the meta device)
NORM_CENSUS = [(96, 96, 96, 64), (48, 48, 96, 128), (48, 48, 96, 64), (48, 48, 96, 32),
               (24, 24, 48, 256), (24, 24, 48, 128), (24, 24, 48, 64), (12, 12, 24, 512),
               (12, 12, 24, 256), (12, 12, 24, 128), (6, 6, 12, 1024), (6, 6, 12, 256)]


@pytest.mark.parametrize("batch", [1, 4])
def test_norm_plan_takes_every_census_site(batch):
    """K8's plan gives every site a regime the C entry accepts, and the
    one-launch on-chip regime wherever one sample's slab of 64 channels (a
    whole 128-byte line a row) fits a cluster of 8 CTAs: every site up to
    12x12x24."""
    onchip = []
    for *space, c in NORM_CENSUS:
        s = int(np.prod(space))
        p = norm.plan(batch, s, c)
        fits = c % norm.GROUP == 0 and s * norm.GROUP * 2 <= norm.MAX_CLUSTER * norm.SLAB_BYTES
        assert p.onchip == fits, (space, c)
        if p.onchip:
            assert 1 <= p.cluster <= norm.MAX_CLUSTER and p.splits == 0
            assert p.rows * p.cluster >= s > p.rows * (p.cluster - 1)
            assert p.rows * norm.GROUP * 2 <= norm.SLAB_BYTES
            onchip.append(tuple(space))
        else:
            assert 1 <= p.splits <= 65535 and p.cluster == 0
    assert sorted(set(onchip)) == [(6, 6, 12), (12, 12, 24)]


def test_gelu_table_range_holds_every_other_value_exactly():
    """K4 reads bf16(gelu(h)) for a bf16 h from a table when |h| lies in
    [2^-10, 8) (csrc/ffn.cu, ffnk::LUT_E0 and LUT_HALF) and computes it
    otherwise as bf16(h / 2) below, h or -0 above (the formula times 2 or
    0). Those reductions must equal the fp32 erf formula for every bf16
    value outside the table."""
    u = torch.arange(65536, dtype=torch.int32)
    h = (u << 16).view(torch.float32)
    formula = (0.5 * h * (1.0 + torch.erf(h * 0.70710678118654752))).to(torch.bfloat16)
    a, negative = u & 0x7FFF, (u >> 15).bool()
    below, above = a < (117 << 7), a >= (130 << 7)
    assert int((~below & ~above & ~negative).sum()) == 13 * 128  # the table's half
    rule = torch.where(below, 0.5 * h, 0.5 * h * torch.where(negative, 0.0, 2.0))
    rule = rule.to(torch.bfloat16)
    outside = (below | above) & torch.isfinite(h)
    assert torch.equal(rule[outside].view(torch.int16), formula[outside].view(torch.int16))


@pytest.mark.parametrize("c", [128, 256])
def test_pixelweight_packing_unpacks_to_the_weights(c):
    """K7's weight image (``pixelweight.pack_weights``, the plain version of
    the C entry's packing launch) read back entry by entry, as the kernel
    walks it, gives W_qkv1, W_qkv2 and W_out again: per head pair, per head
    and stream one 96 x 64 entry per K block (q, k, v rows of the head; at
    C 256 stream 2's q|k and v in 64- and 32-row entries), then 128 x 64
    entries of W_out's pair columns; chunk c of row n stored at chunk
    c ^ (n % 8)."""
    rng = np.random.default_rng(31)
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
          for s in ((3 * c, c), (3 * c, c), (c, c))]
    packed = pixelweight.pack_weights(*ws).float().numpy()
    assert packed.size == 7 * c * c
    got = [np.full(tuple(w.shape), np.nan, np.float32) for w in ws]
    pos = np.arange(8)[None, :]
    off = 0
    for p in range(c // 64):
        for hh in range(2):
            h = 2 * p + hh
            # (stream, first row, rows) of each K block's entries, in order
            parts = [(0, 0, 96), (1, 0, 96)] if c < 256 else [(0, 0, 96), (1, 0, 64), (1, 64, 32)]
            for s, r0, nr in parts:
                for kb in range(c // 64):
                    e = packed[off:off + nr * 64].reshape(nr, 8, 8)
                    off += nr * 64
                    rows = r0 + np.arange(nr)[:, None]
                    r = (rows // 32) * c + h * 32 + rows % 32
                    cols = kb * 64 + (pos ^ (rows % 8)) * 8
                    for k in range(8):
                        got[s][r, cols + k] = e[:, :, k]
        orows = np.arange(128)[:, None]
        for nb in range(c // 128):
            e = packed[off:off + 128 * 64].reshape(128, 8, 8)
            off += 128 * 64
            cols = 64 * p + (pos ^ (orows % 8)) * 8
            for k in range(8):
                got[2][nb * 128 + orows, cols + k] = e[:, :, k]
    assert off == packed.size
    for g, w in zip(got, ws):
        np.testing.assert_array_equal(g, w.float().numpy())
