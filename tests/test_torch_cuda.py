"""CUDA kernels of the port against their plain versions, at small shapes.
Marked ``cuda``: they need a card and skip without one (run them on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py -q``). The full
main-path shapes are checked by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu_torch.ops import (attention, conv3x3, ffn, norm, pixelweight, scatter,
                                         shuffle, winograd)
from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(gen, *shape, dtype=torch.float32, std=1.0, dev=None):
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


def _bf16_close(got, want):
    """Same bound as chip_smoke.py: summation order differs inside the
    matmuls, so values may sit a bf16 ulp or two apart."""
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= 2.0 ** -5 * want.float().abs().max().item()
    assert (d.norm() / want.float().norm()).item() <= 1e-2


def test_scatter_bit_exact(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    imp = torch.tensor(gaussian_importance_map((20, 16, 12)), device=dev)
    pred = _randn(gen, 3, 20, 16, 12, 5, dtype=BF, dev=dev)
    acc = _randn(gen, 41, 30, 29, 6, dev=dev)
    starts = np.array([[0, 0, 0], [6, 2, 17], [21, 14, 9]], np.int32)
    got = scatter.scatter_add_windows(acc.clone(), pred, imp, starts)
    want = scatter.reference_scatter_add_windows(acc.clone(), pred, imp, starts)
    assert torch.equal(got, want)


def _scatter_case(dev, seed, canvas, roi, C, n, dtype=BF):
    """Random canvas and predictions; window starts random, the first two
    at opposite corners (the rows between them in the bounding box are
    uncovered unless a later window falls there), every z-start not a
    multiple of 4 where the canvas allows (unaligned canvas runs)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hi = [c - r for c, r in zip(canvas, roi)]
    starts = np.stack([rng.integers(0, h + 1, n) for h in hi], -1).astype(np.int32)
    starts[0, :2], starts[min(1, n - 1), :2] = 0, hi[:2]
    odd = starts[:, 2] % 4 == 0
    starts[odd, 2] = np.minimum(starts[odd, 2] + 1, hi[2])
    imp = torch.tensor(gaussian_importance_map(roi), device=dev)
    pred = _randn(gen, n, *roi, C, dtype=dtype, dev=dev)
    acc = _randn(gen, *canvas, C + 1, dev=dev)
    return acc, pred, imp, starts


@pytest.mark.parametrize("C", [3, 14])
@pytest.mark.parametrize("n", [1, 2, 4, 33])
def test_scatter_rows_bit_exact(dev, C, n):
    """K1 bit for bit against its plain version: C 14 (the constant-C
    instance) and 3 (runtime C; its 12 x 3 bf16 rows are not 16-byte
    multiples, so they are staged by element copies), 1-4 windows and 33
    (two launches of at most 32), unaligned z-starts, uncovered rows."""
    acc, pred, imp, starts = _scatter_case(dev, 10 * n + C, (33, 29, 37), (10, 9, 12), C, n)
    launches = scatter.scatter_add_windows.launches
    got = scatter.scatter_add_windows(acc.clone(), pred, imp, starts)
    assert scatter.scatter_add_windows.launches - launches == -(-n // 32)
    assert torch.equal(got, scatter.reference_scatter_add_windows(acc.clone(), pred, imp, starts))


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_scatter_rows_in_groups(dev, dtype):
    """Long rows (rz 400): a ring stage holds fewer windows than cover a
    row, so each row is summed in groups, in window order."""
    acc, pred, imp, starts = _scatter_case(dev, 77, (7, 6, 450), (4, 4, 400), 14, 9, dtype)
    got = scatter.scatter_add_windows(acc.clone(), pred, imp, starts)
    assert torch.equal(got, scatter.reference_scatter_add_windows(acc.clone(), pred, imp, starts))


def test_scatter_rows_at_the_shared_memory_limit(dev):
    """8 bf16 windows of rz 96, C 14 (a chunk of the bench at sw 8): a ring
    of exactly 48 KB, which with the kernel's static shared memory needs the
    opt-in."""
    acc, pred, imp, starts = _scatter_case(dev, 8, (10, 9, 100), (4, 4, 96), 14, 8)
    got = scatter.scatter_add_windows(acc.clone(), pred, imp, starts)
    assert torch.equal(got, scatter.reference_scatter_add_windows(acc.clone(), pred, imp, starts))


def _attention_inputs(gen, n, window, c, dev, ld=None):
    """q (pre-scaled), k, v as strided row views of one qkv tensor whose rows
    are ``ld`` >= 3c wide, and a ((2w-1)^3, heads) fp32 table."""
    qkv = _randn(gen, n, window ** 3, ld or 3 * c, dtype=BF, dev=dev)
    q, k, v = qkv[..., :c] * 32 ** -0.5, qkv[..., c:2 * c], qkv[..., 2 * c:3 * c]
    return q, k, v, _randn(gen, (2 * window - 1) ** 3, c // 32, dev=dev)


@pytest.mark.parametrize("n,window,c", [(9, 6, 256), (3, 6, 768), (7, 3, 64), (12, 2, 64)])
def test_window_attention(dev, n, window, c):
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, table = _attention_inputs(gen, n, window, c, dev)
    _bf16_close(attention.window_attention(q, k, v, table, window, BF),
                attention.reference_window_attention_table(q, k, v, table, window, BF))


def test_window_attention_strided_views(dev):
    """q, k, v rows strided by a leading dim wider than 3C (as slices of a
    padded projection), and k / v taken out of order."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v, table = _attention_inputs(gen, 5, 6, 64, dev, ld=3 * 64 + 40)
    assert k.stride(1) == v.stride(1) == 232
    _bf16_close(attention.window_attention(q, v, k, table, 6, BF),
                attention.reference_window_attention_table(q, v, k, table, 6, BF))


def test_window_attention_table_gradient(dev):
    """The gradient reaches the table through the plain version's gather."""
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v, table = _attention_inputs(gen, 4, 6, 64, dev)
    proj = torch.randn(4, 216, 64, generator=gen, device=dev)
    grads = []
    for fn in (attention.window_attention, attention.reference_window_attention_table):
        leaf = table.detach().clone().requires_grad_()
        (fn(q, k, v, leaf, 6, BF).float() * proj).sum().backward()
        grads.append(leaf.grad)
    assert grads[0].abs().max().item() > 0
    # the gather's backward accumulates with atomics: equal up to sum order
    assert ((grads[0] - grads[1]).norm() / grads[1].norm()).item() <= 1e-6


# Swin-UNETR's attention at a 96^3 ROI, a 4-window chunk: (windows, C, heads,
# window, padded grid, shift); stages 1-3 shifted and not, stage 4 at 6^3
_SWIN_ATTENTION = [(4 * 343, 48, 3, 7, (49, 49, 49), 3), (4 * 343, 48, 3, 7, (49, 49, 49), 0),
                   (4 * 64, 96, 6, 7, (28, 28, 28), 3), (4 * 8, 192, 12, 7, (14, 14, 14), 3),
                   (4 * 8, 192, 12, 7, (14, 14, 14), 0), (4, 384, 24, 6, (6, 6, 6), 0),
                   (2 * 27, 48, 3, 7, (21, 21, 21), 3)]


def _swin_inputs(gen, n, c, heads, window, dev):
    qkv = _randn(gen, n, window ** 3, 3 * c, dtype=BF, dev=dev)
    q, k, v = qkv[..., :c] * 16 ** -0.5, qkv[..., c:2 * c], qkv[..., 2 * c:]
    return q, k, v, _randn(gen, 13 ** 3, heads, dev=dev)


@pytest.mark.parametrize("n,c,heads,window,grid,shift", _SWIN_ATTENTION)
def test_window_attention_head_width_16(dev, n, c, heads, window, grid, shift):
    """K2's head-width-16 instance at Swin-UNETR's shapes: 7^3 windows,
    shifted (the region mask computed in the kernel) and not, and 6^3
    windows indexed over a 7^3 layout, against the plain version (bias
    gathered, mask materialized); the gradients through the plain version;
    the window counters."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, table = _swin_inputs(gen, n, c, heads, window, dev)
    kw = dict(index_window=7, shift=(grid, shift) if shift else None)
    assert attention.supports(window ** 3, c, heads, BF, 7)
    windows, masked = attention.window_attention.windows, attention.window_attention.masked_windows
    got = attention.window_attention(q, k, v, table, window, BF, **kw)
    want = attention.reference_window_attention_table(q, k, v, table, window, BF, **kw)
    _bf16_close(got, want)
    assert torch.equal(got, attention.window_attention(q, k, v, table, window, BF, **kw))
    assert attention.window_attention.windows == windows + 2 * n
    nx = grid[0] // window
    edge = n // nx ** 3 * (nx ** 3 - (nx - 1) ** 3) if shift else 0
    assert attention.window_attention.masked_windows == masked + 2 * edge
    proj = torch.randn(got.shape, generator=gen, device=dev)
    grads = []
    for fn in (attention.window_attention, attention.reference_window_attention_table):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
        (fn(*leaves, window, BF, **kw).float() * proj).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert ((g - w).norm() / w.norm()).item() <= 1e-6


def test_window_attention_mask_matters(dev):
    """A shifted block's masked windows differ from the same windows
    unmasked, and its interior windows do not."""
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v, table = _swin_inputs(gen, 27, 48, 3, 7, dev)
    masked = attention.window_attention(q, k, v, table, 7, BF, index_window=7,
                                        shift=((21, 21, 21), 3))
    plain = attention.window_attention(q, k, v, table, 7, BF, index_window=7)
    same = (masked == plain).flatten(1).all(1)
    # windows (x, y, z) of a 3 x 3 x 3 grid: interior where no coordinate is the last
    assert same.tolist() == [max(i // 9, i // 3 % 3, i % 3) < 2 for i in range(27)]


def test_window_attention_head_width_32_unchanged(dev):
    """Today's instance is taken only as it was: head width 32 over w^3 <= 216
    indexed as themselves; the width-16 instance only at Swin's 7^3 and
    6^3 windows over a 7^3 index."""
    assert attention.supports(216, 256, 8, BF) and not attention.supports(216, 256, 8, BF, 7)
    assert not attention.supports(343, 224, 7, BF)
    assert not attention.supports(216, 48, 3, BF) and attention.supports(216, 48, 3, BF, 7)
    assert not attention.supports(64, 48, 3, BF, 7) and not attention.supports(343, 48, 3,
                                                                                torch.float32, 7)


def _ffn_params(gen, c, h, dev):
    return (1 + _randn(gen, c, std=0.1, dev=dev), _randn(gen, c, std=0.1, dev=dev),
            _randn(gen, h, c, std=c ** -0.5, dev=dev), _randn(gen, h, std=0.1, dev=dev),
            _randn(gen, c, h, std=h ** -0.5, dev=dev), _randn(gen, c, std=0.1, dev=dev))


@pytest.mark.parametrize("c", [128, 256])
def test_ffn(dev, c):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = _randn(gen, 3, 5, 7, c, dtype=BF, dev=dev)  # 105 rows: a ragged tile
    p = _ffn_params(gen, c, 4 * c, dev)
    _bf16_close(ffn.ffn(x, *p, BF, residual=True), x + ffn.reference_ffn(x, *p, BF))
    _bf16_close(ffn.ffn(x, *p, BF), ffn.reference_ffn(x, *p, BF))


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("rows,hidden,wdtype,residual", [
    (1, None, torch.float32, True),                    # one row of one tile
    (63, None, torch.bfloat16, False),                 # less than one warpgroup's 64 rows
    (129, None, torch.float32, False),                 # one row into a second tile
    (1000, None, torch.bfloat16, True),                # a ragged last tile
    (2 * 132 * 128 + 37, None, torch.float32, True),   # more tiles than a 132-SM grid holds
    (300, 64, torch.float32, True)])                   # one hidden chunk
def test_ffn_tilings(dev, c, rows, hidden, wdtype, residual):
    """K3's persistent grid at its edges, weights fp32 (as the layer holds
    them) or bf16, against the plain version and against itself on a rerun,
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(19)
    x = _randn(gen, rows, c, dtype=BF, dev=dev)
    ln_w, ln_b, *w = _ffn_params(gen, c, hidden or 4 * c, dev)
    p = (ln_w, ln_b, *(t.to(wdtype) for t in w))
    got = ffn.ffn(x, *p, BF, residual=residual)
    want = ffn.reference_ffn(x, *p, BF)
    _bf16_close(got, x + want if residual else want)
    assert torch.equal(got, ffn.ffn(x, *p, BF, residual=residual))


def test_ffn_pair(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _randn(gen, 2, 9, 11, 128, dtype=BF, dev=dev)
    p1, p2 = _ffn_params(gen, 128, 512, dev), _ffn_params(gen, 128, 512, dev)
    _bf16_close(ffn.ffn_pair(x, p1, p2, BF), ffn.reference_ffn_pair(x, p1, p2, BF))


def _pair_params(gen, hidden, wdtype, dev, w1_scale=1.0):
    ln_w, ln_b, w1, b1, w2, b2 = _ffn_params(gen, 128, hidden, dev)
    return (ln_w, ln_b, *(t.to(wdtype) for t in (w1 * w1_scale, b1, w2, b2)))


@pytest.mark.parametrize("rows,hidden,wdtype", [
    (37, 512, torch.float32),                   # fewer rows than one 128-row tile
    (3 * 128 + 45, 512, torch.bfloat16),        # a ragged last tile, bf16 weights
    (2 * 132 * 128 + 37, 512, torch.float32),   # more tiles than a 132-SM grid holds
    (300, 1024, torch.float32),                 # the widest hidden the gate takes
    (200, 64, torch.float32)])                  # one hidden chunk
def test_ffn_pair_tilings(dev, rows, hidden, wdtype):
    """K4's persistent grid at its edges, against the plain version and
    against itself on a rerun, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(15)
    x = _randn(gen, rows, 128, dtype=BF, dev=dev)
    p1, p2 = _pair_params(gen, hidden, wdtype, dev), _pair_params(gen, hidden, wdtype, dev)
    got = ffn.ffn_pair(x, p1, p2, BF)
    _bf16_close(got, ffn.reference_ffn_pair(x, p1, p2, BF))
    assert torch.equal(got, ffn.ffn_pair(x, p1, p2, BF))


def test_ffn_pair_gelu_outside_the_table(dev):
    """fc1 weights scaled up so that hidden values reach past the GELU
    table's range (|h| >= 8) on both signs, and below it (|h| < 2^-10)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    x = _randn(gen, 700, 128, dtype=BF, dev=dev)
    p1 = _pair_params(gen, 512, torch.float32, dev, w1_scale=16.0)
    p2 = _pair_params(gen, 512, torch.float32, dev, w1_scale=16.0)
    h = torch.matmul(ffn.layer_norm(x, p1[0], p1[1]), p1[2].to(BF).t()).float()
    assert (h > 8).any() and (h < -8).any() and (h.abs() < 2 ** -10).any()
    _bf16_close(ffn.ffn_pair(x, p1, p2, BF), ffn.reference_ffn_pair(x, p1, p2, BF))


def test_ffn_pair_raises_on_other_widths(dev):
    gen = torch.Generator(device=dev).manual_seed(17)
    x = _randn(gen, 10, 256, dtype=BF, dev=dev)
    p = _ffn_params(gen, 256, 1024, dev)
    with pytest.raises(ValueError):
        ffn.ffn_pair(x, p, p, BF)  # C 256 runs as two ffn calls, not the pair


@pytest.mark.parametrize("c,factor,f", [(768, (2, 2, 2), 512), (512, (2, 2, 2), 256),
                                        (256, (2, 2, 2), 128), (128, (2, 2, 1), 64)])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7),    # 210 voxels
                                   (1, 3, 5, 7),    # 105 and 330: not a multiple of
                                   (2, 5, 3, 11)])  # the 8-voxel group
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_pixel_shuffle(dev, c, factor, f, shape, wdtype):
    """K5 at each pyramid site's channels, factor and features, at reduced
    size, w and b fp32 (as the layer holds them) or bf16; a rerun is
    bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _randn(gen, *shape, c, dtype=BF, dev=dev)
    cp = c // int(np.prod(factor))
    w = _randn(gen, f, cp, std=cp ** -0.5, dev=dev).to(wdtype)
    b = _randn(gen, f, std=0.1, dev=dev).to(wdtype)
    got = shuffle.pixel_shuffle_linear(x, w, b, factor, BF)
    _bf16_close(got, shuffle.reference_shuffle(x, w, b, factor, BF))
    assert torch.equal(got, shuffle.pixel_shuffle_linear(x, w, b, factor, BF))


@pytest.mark.parametrize("shape,k", [((2, 3, 5, 7, 256), (2, 2, 2)),
                                     ((1, 5, 3, 9, 128), (2, 2, 1)),
                                     ((3, 2, 2, 3, 1024), (2, 2, 2))])  # M 36 < one tile
def test_transp_conv(dev, shape, k):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, *shape, dtype=BF, dev=dev)
    cout = shape[-1] // 2
    w = _randn(gen, shape[-1], cout, *k, std=shape[-1] ** -0.5, dev=dev)
    got = shuffle.transp_conv_kxs(x, w, BF)
    assert got.shape == (shape[0], shape[1] * k[0], shape[2] * k[1], shape[3] * k[2], cout)
    _bf16_close(got, shuffle.reference_transp_conv(x, w, BF))


@pytest.mark.parametrize("cin,cout,k", [(1024, 512, (2, 2, 2)), (512, 256, (2, 2, 2)),
                                         (256, 128, (2, 2, 2)), (128, 64, (2, 2, 1))])
@pytest.mark.parametrize("shape,wdtype", [((1, 2, 3, 5), torch.float32),     # M 30 < one tile
                                          ((2, 7, 5, 9), torch.bfloat16)])  # M 630: ragged
def test_transp_conv_site_geometries(dev, cin, cout, k, shape, wdtype):
    """K6 at each decoder site's channels and kernel, at reduced M, with the
    weight as the layer holds it (fp32) or in bf16; a rerun is bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(18)
    x = _randn(gen, *shape, cin, dtype=BF, dev=dev)
    w = _randn(gen, cin, cout, *k, std=cin ** -0.5, dev=dev).to(wdtype)
    got = shuffle.transp_conv_kxs(x, w, BF)
    assert got.shape == (shape[0], shape[1] * k[0], shape[2] * k[1], shape[3] * k[2], cout)
    _bf16_close(got, shuffle.reference_transp_conv(x, w, BF))
    assert torch.equal(got, shuffle.transp_conv_kxs(x, w, BF))


def _pixelweight_params(gen, c, dev, wdtype=torch.float32):
    return [1 + _randn(gen, c, std=0.1, dev=dev), _randn(gen, c, std=0.1, dev=dev),
            1 + _randn(gen, c, std=0.1, dev=dev), _randn(gen, c, std=0.1, dev=dev),
            *[_randn(gen, *s, std=c ** -0.5, dev=dev).to(wdtype)
              for s in ((3 * c, c), (3 * c, c), (c, c))]]


@pytest.mark.parametrize("c,rows", [(128, 1000), (256, 200), (512, 77),  # ragged last tiles
                                    (128, 2 * 132 * 128 + 37),  # more 128-row tiles than CTAs
                                    (256, 132 * 128 + 77),
                                    (512, 2 * 132 * 64 + 5)])   # more 64-row tiles than CTAs
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_pixelweight(dev, c, rows, wdtype):
    """K7 at each width, weights fp32 (as the layer holds them) or bf16; a
    rerun is bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x1, x2 = (_randn(gen, rows, c, dtype=BF, dev=dev) for _ in range(2))
    p = _pixelweight_params(gen, c, dev, wdtype)
    got = pixelweight.pixelweight(x1, x2, p, BF)
    _bf16_close(got, pixelweight.reference_pixelweight(x1, x2, p, BF))
    assert torch.equal(got, pixelweight.pixelweight(x1, x2, p, BF))


@pytest.mark.parametrize("c", [128, 256, 512])
def test_pixelweight_offset_inputs(dev, c):
    """Inputs with |mean| ~ 30 and unit spread: the LN's two-pass statistics."""
    gen = torch.Generator(device=dev).manual_seed(22)
    x1 = _randn(gen, 300, c, dev=dev).add_(30.0).to(BF)
    x2 = _randn(gen, 300, c, dev=dev).sub_(30.0).to(BF)
    p = _pixelweight_params(gen, c, dev)
    _bf16_close(pixelweight.pixelweight(x1, x2, p, BF),
                pixelweight.reference_pixelweight(x1, x2, p, BF))


@pytest.mark.parametrize("c", [128, 256, 512])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_pixelweight_packing_launch(dev, c, wdtype):
    """The C entry's packing launch writes pack_weights' image, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(23)
    w = _pixelweight_params(gen, c, dev, wdtype)[4:]
    got = pixelweight.device_pack(*w).cpu()
    assert torch.equal(got.view(torch.int16),
                       pixelweight.pack_weights(*[t.cpu() for t in w]).view(torch.int16))


@pytest.mark.parametrize("shape", [(2, 5, 7, 9, 64),      # S 315: two splits
                                   (4, 6, 6, 12, 1024),   # the deepest ResNet stage
                                   (1, 23, 17, 29, 32),   # S 11339: not a multiple of the split
                                   (2, 40, 40, 37, 128)])
@pytest.mark.parametrize("act", [False, True])
def test_instance_norm(dev, shape, act):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = (3.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    S = shape[1] * shape[2] * shape[3]
    p = norm.plan(shape[0], S, shape[-1])
    assert p.cluster >= 1 if p.onchip else p.splits >= 1
    got = norm.instance_norm_leaky(x) if act else norm.instance_norm(x)
    want = norm.reference_instance_norm(x)
    if act:
        want = torch.nn.functional.leaky_relu(want, 0.01)
    _bf16_close(got, want)
    again = norm.instance_norm_leaky(x) if act else norm.instance_norm(x)
    assert torch.equal(got, again)  # fixed summation order: reproducible


@pytest.mark.parametrize("shape,onchip,cluster", [
    ((1, 1, 1, 31, 64), True, 1),         # fewer than 32 rows: one CTA
    ((1, 3, 5, 7, 64), True, 4),          # S 105, odd: four CTAs of 27 rows
    ((4, 6, 6, 12, 1024), True, 5),       # the deepest site: a cluster of 5
    ((1, 7, 17, 29, 128), True, 8),       # S 3451, odd
    ((4, 1, 1, 3455, 2048), True, 4),     # the widest C
    ((1, 1, 1, 6912, 64), True, 8),       # slabs that fill 8 CTAs exactly
    ((1, 1, 1, 6913, 64), False, 0),      # one row more: two passes
    ((1, 1, 1, 6912, 2048), True, 8),     # the same at the widest C
    ((1, 1, 1, 6913, 2048), False, 0),
    ((1, 3, 5, 7, 32), False, 0),         # fewer than 64 channels: two passes
    ((1, 23, 17, 29, 32), False, 0),      # S 11339, odd
    ((2, 40, 40, 37, 128), False, 0)])
@pytest.mark.parametrize("act", [False, True])
def test_instance_norm_regimes(dev, shape, onchip, cluster, act):
    """K8 on each regime of ``norm.plan`` and at the cluster's edges, against
    the plain version and against itself on a rerun, bit for bit."""
    B, S, C = shape[0], shape[1] * shape[2] * shape[3], shape[-1]
    p = norm.plan(B, S, C)
    assert (p.onchip, p.cluster) == (onchip, cluster)
    gen = torch.Generator(device=dev).manual_seed(20)
    x = (3.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    run = norm.instance_norm_leaky if act else norm.instance_norm
    got = run(x)
    want = norm.reference_instance_norm(x)
    _bf16_close(got, torch.nn.functional.leaky_relu(want, 0.01) if act else want)
    assert torch.equal(got, run(x))


# every residual tail of the three models at a 4-window batch (K8 tail shapes)
_TAIL_SITES = [(4, 96, 96, 96, 64), (4, 48, 48, 96, 128), (4, 24, 24, 48, 256),
               (4, 12, 12, 24, 512), (4, 6, 6, 12, 1024)]
_REGIME_SHAPES = [(1, 1, 1, 31, 64), (1, 3, 5, 7, 64), (1, 7, 17, 29, 128), (4, 1, 1, 3455, 2048),
                  (1, 1, 1, 6912, 64), (1, 1, 1, 6913, 64), (1, 1, 1, 6912, 2048),
                  (1, 1, 1, 6913, 2048), (1, 3, 5, 7, 32), (1, 23, 17, 29, 32),
                  (2, 40, 40, 37, 128)]


@pytest.mark.parametrize("shape", _TAIL_SITES + _REGIME_SHAPES)
@pytest.mark.parametrize("r_raw", [False, True])
def test_instance_norm_tail_bit_identical(dev, shape, r_raw):
    """K8's residual tail against the unfused sequence it replaces (K8 of a
    [and of the raw residual], torch's add and LeakyReLU), bit for bit, on
    both plans, folded where ``norm.folds``; against itself on a rerun and
    near the plain composition; counted once on each counter."""
    gen = torch.Generator(device=dev).manual_seed(21)
    a = (0.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    r = ((0.5 if r_raw else 0.0) + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    launches, tails = norm.instance_norm.launches, norm.instance_norm.residual_launches
    got = norm.instance_norm_add_leaky(a, r, r_raw)
    folded = r_raw and norm.folds(shape)
    assert norm.instance_norm.residual_launches == tails + 1
    assert norm.instance_norm.launches == launches + (2 if r_raw and not folded else 1)
    res = norm.instance_norm(r) if r_raw else r
    assert torch.equal(got, torch.nn.functional.leaky_relu(norm.instance_norm(a) + res, 0.01))
    assert torch.equal(got, norm.instance_norm_add_leaky(a, r, r_raw))
    plain = norm.reference_instance_norm(r) if r_raw else r
    _bf16_close(got, torch.nn.functional.leaky_relu(norm.reference_instance_norm(a) + plain,
                                                    0.01))


# every InstanceNorm and tail width of Swin-UNETR (C = 48 * 2^k) at its sites'
# sizes and at edges of each regime
_SWIN_NORM = [(4, 96, 96, 96, 48), (4, 48, 48, 48, 48), (4, 24, 24, 24, 96), (4, 12, 12, 12, 192),
              (4, 6, 6, 6, 384), (4, 3, 3, 3, 768), (1, 23, 17, 29, 48), (2, 5, 7, 9, 96),
              (1, 40, 40, 37, 192), (1, 1, 1, 6913, 384), (2, 3, 5, 7, 768)]


@pytest.mark.parametrize("shape", _SWIN_NORM)
def test_instance_norm_swin_widths(dev, shape):
    """K8 at C = 48 * 2^k in every form (norm, norm + LeakyReLU, the tail
    with the residual as is and raw, folded where ``norm.folds``): against
    the plain composition, the tail bit for bit against the unfused K8
    sequence, reruns bit for bit, counted on ``launches_48``."""
    B, S, C = shape[0], shape[1] * shape[2] * shape[3], shape[-1]
    assert norm.pass_threads(C) == 192 and norm.supports(torch.zeros(1, 1, 1, 1, C, dtype=BF))
    gen = torch.Generator(device=dev).manual_seed(33)
    a = (0.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    r = (0.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(BF)
    before = norm.instance_norm.launches_48
    y = norm.instance_norm(a)
    _bf16_close(y, norm.reference_instance_norm(a))
    assert torch.equal(y, norm.instance_norm(a))
    yl = norm.instance_norm_leaky(a)
    _bf16_close(yl, torch.nn.functional.leaky_relu(norm.reference_instance_norm(a), 0.01))
    assert norm.instance_norm.launches_48 == before + 3
    for r_raw in (False, True):
        got = norm.instance_norm_add_leaky(a, r, r_raw)
        res = norm.instance_norm(r) if r_raw else r
        assert torch.equal(got, torch.nn.functional.leaky_relu(y + res, 0.01))
        assert torch.equal(got, norm.instance_norm_add_leaky(a, r, r_raw))
        plain = norm.reference_instance_norm(r) if r_raw else r
        _bf16_close(got, torch.nn.functional.leaky_relu(norm.reference_instance_norm(a) + plain,
                                                        0.01))


def test_instance_norm_tail_folds_at_the_projection_sites(dev):
    """The two-pass projection sites fold; the on-chip ones do not."""
    assert [norm.folds(s) for s in _TAIL_SITES] == [True, True, True, False, False]


def test_wrappers_raise_on_unsupported(dev):
    x = torch.zeros(2, 64, device=dev, dtype=BF)
    p = [torch.zeros(s, device=dev) for s in (64, 64, (256, 64), 256, (64, 256), 64)]
    with pytest.raises(ValueError):
        ffn.ffn(x, *p, BF)  # C = 64 has no kernel instance
    with pytest.raises(ValueError):
        # 5 vectors a row: divides neither block (256 or 192 threads)
        norm.instance_norm(torch.zeros(1, 2, 2, 2, 40, device=dev, dtype=BF))
    with pytest.raises(ValueError):  # a residual of another shape
        norm.instance_norm_add_leaky(torch.zeros(1, 2, 2, 2, 64, device=dev, dtype=BF),
                                     torch.zeros(1, 2, 2, 1, 64, device=dev, dtype=BF))
    with pytest.raises(ValueError):
        shuffle.transp_conv_kxs(torch.zeros(1, 2, 2, 2, 48, device=dev, dtype=BF),
                                torch.zeros(48, 64, 2, 2, 2, device=dev), BF)


@pytest.mark.parametrize("shape,f", [((2, 6, 10, 12, 32), 32),    # ragged tile blocks
                                     ((1, 8, 8, 16, 32), 64),
                                     ((1, 4, 6, 8, 32), 128),
                                     ((1, 10, 14, 18, 32), 64),   # 5x7x9 tiles: ragged in x, y, z
                                     ((1, 10, 14, 18, 32), 128),
                                     ((3, 2, 2, 2, 32), 32)])     # one tile per sample
def test_winograd(dev, shape, f):
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _randn(gen, *shape, dtype=BF, dev=dev)
    w = _randn(gen, f, 32, 3, 3, 3, std=(2.0 / (27 * 32)) ** 0.5, dev=dev)
    got = winograd.conv3x3_winograd(x, w)
    _bf16_close(got, winograd.reference_conv3x3_winograd(x, w))
    _bf16_close(got, winograd.direct_conv3x3(x, w.to(BF)))


def test_conv3d_same_routes_bf16_sites_to_k9(dev):
    """On the card conv3d_same hands a gated bf16 conv to K9 and everything
    else (fp32, stride 2) to the direct conv."""
    from hybrid_ctunet_tpu_torch.ops import conv as conv_ops

    gen = torch.Generator(device=dev).manual_seed(12)
    x = _randn(gen, 1, 4, 4, 6, 32, dev=dev)
    w = _randn(gen, 64, 32, 3, 3, 3, std=0.05, dev=dev)
    before = winograd.conv3x3_winograd.launches
    conv_ops.conv3d_same(x, w)
    conv_ops.conv3d_same(x.to(BF), w.to(BF), stride=2)
    assert winograd.conv3x3_winograd.launches == before
    _bf16_close(conv_ops.conv3d_same(x.to(BF), w.to(BF)), winograd.direct_conv3x3(x.to(BF), w))
    assert winograd.conv3x3_winograd.launches == before + 1


@pytest.mark.parametrize("shape,f", [((2, 6, 10, 12, 32), 32), ((1, 10, 14, 18, 32), 64)])
def test_winograd_fused_stats_reproducible(dev, shape, f):
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _randn(gen, *shape, dtype=BF, dev=dev)
    w = _randn(gen, f, 32, 3, 3, 3, std=(2.0 / (27 * 32)) ** 0.5, dev=dev)
    scale = 1 + _randn(gen, shape[0], 32, std=0.1, dev=dev)
    bias = _randn(gen, shape[0], 32, std=0.1, dev=dev)
    got = winograd.conv3x3_winograd_fused(x, w, (scale, bias), in_act=True, emit_stats=True)
    want = winograd.reference_conv3x3_winograd_fused(x, w, scale, bias, True, True)
    _bf16_close(got[0], want[0])
    for g, p in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, p, rtol=1e-2, atol=1e-2 * p.abs().max().item())
    again = winograd.conv3x3_winograd_fused(x, w, (scale, bias), in_act=True, emit_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _conv3x3_case(dev, seed, shape):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, *shape, dtype=BF, dev=dev)
    w = _randn(gen, 48, shape[-1], 3, 3, 3, std=(2.0 / (27 * shape[-1])) ** 0.5, dev=dev)
    return x, w


@pytest.mark.parametrize("cin", [1, 48, 96])
@pytest.mark.parametrize("space", [(5, 7, 9), (12, 16, 20), (48, 48, 48)])
@pytest.mark.parametrize("batch", [1, 4])
def test_conv3x3(dev, cin, space, batch):
    """K10 against the exact conv of its bf16 operands (fp32 ``F.conv3d``,
    TF32 off) and the plain path (cuDNN in bf16). Ragged bricks (5 x 7 x 9
    and 12 x 16 x 20 are no multiples of the 8^3 brick), one launch a call,
    bit for bit on a rerun. Tolerance: the kernel sums in fp32 and rounds
    once, so it lies within half a bf16 ulp (2^-8 relative) of the exact
    sum, plus the fp32 sums' own rounding in either order (2^-12 of the
    largest output); the plain path rounds once too, so the two may differ
    by an ulp."""
    x, w = _conv3x3_case(dev, 20 + cin + batch, (batch, *space, cin))
    before = conv3x3.conv3x3.launches
    got = conv3x3.conv3x3(x, w)
    assert conv3x3.conv3x3.launches == before + 1
    assert got.shape == (batch, *space, 48) and got.dtype == BF
    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    try:
        exact = torch.nn.functional.conv3d(x.float().permute(0, 4, 1, 2, 3),
                                           w.to(BF).float(), padding=1).permute(0, 2, 3, 4, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    d = (got.float() - exact).abs()
    assert (d <= 2.0 ** -8 * exact.abs() + 2.0 ** -12 * exact.abs().max()).all(), d.max().item()
    _bf16_close(got, conv3x3.reference_conv3x3(x, w))
    assert torch.equal(got, conv3x3.conv3x3(x, w))


def test_conv3x3_takes_bf16_weights_as_fp32_ones(dev):
    """The packing launch reads fp32 or bf16 weights: the same conv either
    way, bit for bit, rounded as ``w.to(bf16)`` rounds."""
    x, w = _conv3x3_case(dev, 5, (2, 9, 10, 11, 96))
    assert torch.equal(conv3x3.conv3x3(x, w), conv3x3.conv3x3(x, w.to(BF)))


def test_conv3x3_refuses_other_shapes(dev):
    """A CUDA tensor the gate declines raises instead of taking another path."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for xs, ws, dtype in (((1, 8, 8, 8, 32), (48, 32, 3, 3, 3), BF),
                          ((1, 8, 8, 8, 48), (64, 48, 3, 3, 3), BF),
                          ((1, 8, 8, 8, 48), (48, 48, 3, 3, 3), torch.float32)):
        with pytest.raises(ValueError):
            conv3x3.conv3x3(_randn(gen, *xs, dtype=dtype, dev=dev), _randn(gen, *ws, dev=dev))


def test_conv3d_same_routes_48_channel_sites_to_k10(dev):
    """conv3d_same hands a gated conv to K10, and fp32 or stride 2 to the
    direct conv."""
    from hybrid_ctunet_tpu_torch.ops import conv as conv_ops

    x, w = _conv3x3_case(dev, 13, (1, 6, 8, 10, 48))
    before = conv3x3.conv3x3.launches
    conv_ops.conv3d_same(x.float(), w)
    conv_ops.conv3d_same(x, w.to(BF), stride=2)
    assert conv3x3.conv3x3.launches == before
    got = conv_ops.conv3d_same(x, w.to(BF))
    assert conv3x3.conv3x3.launches == before + 1
    assert torch.equal(got, conv3x3.conv3x3(x, w.to(BF)))


def _grads(fn, inputs, gen):
    """fn's outputs and the gradients of a fixed random projection of them."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen, device=o.device)).sum()
               for o in outs)
    return torch.autograd.grad(loss, [t for t in leaves if t.requires_grad])


def _kernel_and_plain(dev):
    """(name, wrapper, plain, inputs) of every kernel with a backward."""
    gen = torch.Generator(device=dev).manual_seed(10)
    att = _attention_inputs(gen, 3, 6, 64, dev)
    x128 = _randn(gen, 2, 3, 5, 128, dtype=BF, dev=dev)
    p1, p2 = _ffn_params(gen, 128, 512, dev), _ffn_params(gen, 128, 512, dev)
    pw = [1 + _randn(gen, 128, std=0.1, dev=dev), _randn(gen, 128, std=0.1, dev=dev),
          1 + _randn(gen, 128, std=0.1, dev=dev), _randn(gen, 128, std=0.1, dev=dev),
          _randn(gen, 384, 128, std=128 ** -0.5, dev=dev), _randn(gen, 384, 128, std=128 ** -0.5, dev=dev),
          _randn(gen, 128, 128, std=128 ** -0.5, dev=dev)]
    xs = _randn(gen, 1, 2, 3, 4, 256, dtype=BF, dev=dev)
    ws, bs = _randn(gen, 128, 32, std=32 ** -0.5, dev=dev), _randn(gen, 128, std=0.1, dev=dev)
    wt = _randn(gen, 256, 128, 2, 2, 2, std=0.05, dev=dev)
    xn = (1 + 2 * torch.randn(2, 4, 6, 8, 64, generator=gen, device=dev)).to(BF)
    # residual tails: on chip, and two passes (S 8000) where a raw residual folds
    tails = [tuple((1 + 2 * torch.randn(shape, generator=gen, device=dev)).to(BF)
                   for _ in range(2)) for shape in ((2, 4, 6, 8, 64), (2, 20, 20, 20, 64))]
    xw = _randn(gen, 1, 4, 6, 8, 32, dtype=BF, dev=dev)
    ww = _randn(gen, 32, 32, 3, 3, 3, std=0.05, dev=dev)
    xc = {c: _randn(gen, 2, 5, 7, 9, c, dtype=BF, dev=dev) for c in conv3x3.CINS}
    wc = {c: _randn(gen, 48, c, 3, 3, 3, std=0.05, dev=dev) for c in conv3x3.CINS}
    sc, bi = 1 + _randn(gen, 1, 32, std=0.1, dev=dev), _randn(gen, 1, 32, std=0.1, dev=dev)
    return [
        ("window_attention", lambda *a: attention.window_attention(*a, 6, BF),
         lambda *a: attention.reference_window_attention_table(*a, 6, BF), att),
        ("ffn", lambda x, *p: ffn.ffn(x, *p, BF, residual=True),
         lambda x, *p: x + ffn.reference_ffn(x, *p, BF), (x128, *p1)),
        ("ffn_pair", lambda x, *p: ffn.ffn_pair(x, p[:6], p[6:], BF),
         lambda x, *p: ffn.reference_ffn_pair(x, p[:6], p[6:], BF), (x128, *p1, *p2)),
        ("pixel_shuffle_linear", lambda *a: shuffle.pixel_shuffle_linear(*a, (2, 2, 2), BF),
         lambda *a: shuffle.reference_shuffle(*a, (2, 2, 2), BF), (xs, ws, bs)),
        ("transp_conv_kxs", lambda *a: shuffle.transp_conv_kxs(*a, BF),
         lambda *a: shuffle.reference_transp_conv(*a, BF), (xs, wt)),
        ("pixelweight", lambda a, b, *p: pixelweight.pixelweight(a, b, p, BF),
         lambda a, b, *p: pixelweight.reference_pixelweight(a, b, p, BF), (x128, x128 * 0.5, *pw)),
        ("instance_norm_leaky", norm.instance_norm_leaky,
         lambda x: torch.nn.functional.leaky_relu(norm.reference_instance_norm(x), 0.01), (xn,)),
        *[(f"instance_norm_add_leaky {tuple(t[0].shape)} raw={raw}",
           lambda a, r, raw=raw: norm.instance_norm_add_leaky(a, r, raw),
           lambda a, r, raw=raw: torch.nn.functional.leaky_relu(
               norm.reference_instance_norm(a)
               + (norm.reference_instance_norm(r) if raw else r), 0.01), t)
          for t in tails for raw in (False, True)],
        ("conv3x3_winograd", winograd.conv3x3_winograd, winograd.direct_conv3x3, (xw, ww)),
        *[(f"conv3x3 C {c}", conv3x3.conv3x3, conv3x3.reference_conv3x3, (xc[c], wc[c]))
          for c in conv3x3.CINS],
        ("conv3x3_winograd_fused",
         lambda x, w, s, b: winograd.conv3x3_winograd_fused(x, w, (s, b), in_act=True,
                                                            emit_stats=True),
         lambda x, w, s, b: winograd.direct_conv3x3_fused(x, w, s, b, True, True),
         (xw, ww, sc, bi)),
    ]


def test_kernel_backward_is_the_plain_backward(dev):
    """Each wrapper's backward recomputes through the plain path: gradients
    equal the plain path's own (deterministic cuDNN for K9's direct conv)."""
    torch.backends.cudnn.deterministic, saved = True, torch.backends.cudnn.deterministic
    try:
        for name, kernel_fn, plain_fn, inputs in _kernel_and_plain(dev):
            got = _grads(kernel_fn, inputs, torch.Generator(device=dev).manual_seed(11))
            want = _grads(plain_fn, inputs, torch.Generator(device=dev).manual_seed(11))
            for g, w in zip(got, want):
                rel = ((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item()
                assert rel <= 1e-6, (name, rel)
    finally:
        torch.backends.cudnn.deterministic = saved


def test_remat_step_equals_plain_step_on_the_card(dev):
    """A bf16 CUNet (depth 50, 32^3) train step with block remat against
    the step without: the gradients bit for bit (cuDNN deterministic), and
    K8 and K9 launched once more for each site of a rematerialized block
    (the ResBlocks and each stage's bottlenecks after the first). Each
    block's residual tail is one K8 call, counted on
    ``instance_norm.residual_launches``, and one record fewer where it folds
    its projection's norm (``norm.folds`` at the tail's shape)."""
    import copy

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.models import CUNet, layers, resnet3d
    from hybrid_ctunet_tpu_torch.train import state, steps
    from hybrid_ctunet_tpu_torch.utils.params import random_init_

    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, 2, 32, 32, 32, 1, dev=dev)
    y = torch.randint(0, 3, (2, 32, 32, 32, 1), generator=gen, device=dev)
    base = random_init_(CUNet(out_channels=3, model_depth=50, dtype=BF, device=dev), 0)
    wrapped = [m for m in base.modules() if isinstance(m, layers.ResBlock)]
    wrapped += [b for s in range(1, 5) for b in list(getattr(base.convnet, f"layer{s}"))[1:]]
    norms = sum(isinstance(m, layers.ConvNorm) for w in wrapped for m in w.modules())
    k9 = sum(isinstance(m, resnet3d.Bottleneck) and m.conv2.conv.weight.shape[1] == 32
             and m.conv2.stride == (1, 1, 1) for m in wrapped)
    blocks = [m for m in base.modules() if isinstance(m, (layers.ResBlock, resnet3d.Bottleneck))]
    shapes = {}
    hooks = [b.register_forward_hook(lambda m, i, o: shapes.__setitem__(m, tuple(o.shape)))
             for b in blocks]
    with torch.no_grad():
        base(x)
    for h in hooks:
        h.remove()

    def folds(mods):
        return sum(norm.folds(shapes[b]) for b in mods
                   if (b.needs_proj if isinstance(b, layers.ResBlock)
                       else b.downsample is not None))

    grads, counts = {}, {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for enabled in (True, False):
            model = copy.deepcopy(base)
            step = steps.make_train_step("cunet", model,
                                         state.make_optimizer(model.parameters(), "adamw"))
            kernels.reset_launch_counts()
            with layers.remat_blocks(enabled):
                step(x, y, 0.0)
            torch.cuda.synchronize()
            counts[enabled] = {**kernels.launch_counts(), "tails": kernels.residual_launches()}
            grads[enabled] = [p.grad for p in model.parameters()]
    finally:
        torch.backends.cudnn.deterministic = saved
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    assert counts[False]["conv3x3_winograd"] > 0 and k9 > 0
    assert counts[False]["tails"] == len(blocks) and folds(blocks) > folds(wrapped) > 0
    assert counts[True]["tails"] == len(blocks) + len(wrapped)
    convnorms = sum(isinstance(m, layers.ConvNorm) for m in base.modules())
    assert counts[False]["instance_norm"] == convnorms - folds(blocks)
    assert counts[True]["instance_norm"] == counts[False]["instance_norm"] + norms - folds(wrapped)
    assert counts[True]["conv3x3_winograd"] == counts[False]["conv3x3_winograd"] + k9


def test_train_step_spans_on_the_card(dev):
    """Two TINY CTUNet steps (bf16, 32^3, block remat on) under the
    profiler: every span timed on the device; the recompute's spans, on
    autograd's thread, as many as the regions recomputed and each inside
    its step's ``step.backward``; the phases inside the step's device time;
    no span recorded as a device kernel."""
    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.models import CTUNet, layers
    from hybrid_ctunet_tpu_torch.train import state, steps
    from hybrid_ctunet_tpu_torch.utils import profiling
    from hybrid_ctunet_tpu_torch.utils.params import random_init_

    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, 2, 32, 32, 32, 1, dev=dev)
    y = torch.randint(0, 3, (2, 32, 32, 32, 1), generator=gen, device=dev)
    model = random_init_(CTUNet(out_channels=3, model_depth=50, img_size=(32, 32), frames=32,
                                patch_frame=8, hidden_size=64, num_depths=2, mlp_dim=128,
                                num_heads=2, window=2, dim_conv_stem=16, dtype=BF, device=dev), 0)
    step = steps.make_train_step("ctunet", model, state.make_optimizer(model.parameters()))
    with layers.remat_blocks(True):
        step(x, y, 1e-4)
        kernels.reset_launch_counts()
        n = len(profiling.spans())
        tp = torch.profiler
        with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(x, y, 1e-4)
            torch.cuda.synchronize()
    got = profiling.spans()[n:]
    regions = [r for r in got if r.name == "remat.recompute"]
    assert len(regions) == kernels.recomputes() > 0
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in got)
    for unit in (1, 2):
        (top,) = [r for r in got if r.name == "step" and r.unit == unit]
        phases = {r.name: r for r in got if r.parent is top}
        assert sorted(phases) == ["step.backward", "step.forward", "step.optimizer"]
        assert sum(r.device_ms for r in phases.values()) <= top.device_ms * 1.01
        mine = [r for r in regions if r.unit == unit]
        assert len(mine) == len(regions) // 2
        assert all(r.parent is phases["step.backward"] for r in mine)
        assert sum(r.device_ms for r in mine) <= phases["step.backward"].device_ms
    names = {r.name for r in got}
    assert not [e.name for e in prof.events() if e.name in names
                and "CUDA" in str(e.device_type) and not e.is_user_annotation]
