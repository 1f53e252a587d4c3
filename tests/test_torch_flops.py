"""Useful-FLOP count of the port (``utils/flops.py``) against the JAX tool's
(``tools/mfu_accounting.py``, loaded from its file: it is a script, not a
package): the TINY TUNet and CTUNet of tests/test_torch_ctunet.py traced by
JAX under the tool's plain flags and walked with its ``_walk``, the port's
models counted on the meta device. Integer equality per top-level
component, except where the JAX count is not the reference math (ROADMAP
C10, C11), which the tests here pin."""
import importlib.util
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.models import layers as jlayers
from hybrid_ctunet_tpu.models.ctunet import CTUNet as JCTUNet
from hybrid_ctunet_tpu.models.tunet import TUNet as JTUNet
from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet
from hybrid_ctunet_tpu_torch.utils import flops

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

_spec = importlib.util.spec_from_file_location(
    "mfu_accounting", Path(__file__).resolve().parent.parent / "tools" / "mfu_accounting.py")
MFU = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MFU)

# tests/test_torch_ctunet.py TINY; ResNet depth 50 for CTUNet
TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
ROI = (32, 32, 32)
# tools/mfu_accounting.py::count_model_flops's flags: every structural rewrite off
PLAIN = dict(
    ALTFOLD="0", ZFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
    PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0", PALLAS_SHUFFLE="0",
    TRANSP_PALLAS="0", TRANSP_NATIVE="0", CIN1_MUL="0", PALLAS_SCATTER="0",
)
MODELS = {"tunet": (JTUNet, TUNet, {}), "ctunet": (JCTUNet, CTUNet, dict(model_depth=50))}
STEM = ("CTUNet/convnet/conv1", "convnet.conv1")


def _jax_flops(which, windows):
    """{JAX scope: FLOPs}, as the tool's ``count_model_flops`` counts them."""
    jcls, _, kw = MODELS[which]
    saved = jlayers._REMAT_BLOCKS
    jlayers.set_remat_blocks(False)
    try:
        with flags.override(**PLAIN):
            mod = jcls(dtype=jnp.bfloat16, **TINY, **kw)
            x = jax.ShapeDtypeStruct((windows, *ROI, 1), jnp.bfloat16)
            params = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x)
            jaxpr = jax.make_jaxpr(mod.apply)(params, x)
    finally:
        jlayers.set_remat_blocks(saved)
    acc = defaultdict(int)
    MFU._walk(jaxpr.jaxpr, 1, acc, "")
    return acc


def _port_model(which):
    _, cls, kw = MODELS[which]
    return cls(dtype=torch.bfloat16, device="meta", **TINY, **kw)


def _jax_components(acc):
    comps = defaultdict(int)
    for label, f in acc.items():
        comps[MFU._component(label)] += f
    return comps


@pytest.mark.parametrize("which", ["tunet", "ctunet"])
def test_count_matches_jax_per_component(which):
    """The full forward at 1 and 2 windows: every top-level component equal
    as an integer; 2 windows exactly twice 1. The CTUNet's ResNet differs
    by its stem alone (C10): JAX rewrites the 7x7x7 Cin-1 stride-(2,2,1)
    stem as a 2x2 space-to-depth conv of a (4,4,7) kernel over 4 channels,
    448 taps where the reference conv has 343, and counts the padded taps;
    the port counts the reference conv."""
    port = {w: flops.count_model_flops(_port_model(which), w, roi=ROI) for w in (1, 2)}
    for w in (1, 2):
        jax_flops = _jax_flops(which, w)
        want, got = _jax_components(jax_flops), flops.by_component(port[w])
        assert set(got) == set(want)
        if which == "ctunet":
            jstem, pstem = jax_flops[STEM[0]], port[w][STEM[1]]
            # the reference stem: 64 channels out at 16x16x32 a window, 343 taps of Cin 1
            assert pstem == 2 * w * 16 * 16 * 32 * 64 * 343
            assert jstem * 343 == pstem * 448
            assert want.pop("convnet") - jstem == got.pop("convnet") - pstem
        assert got == want
    assert {k: 2 * v for k, v in port[1].items()} == port[2]


def test_res_only_counts_the_ensemble_predictor():
    """CTUNet ``res_only`` counts the full forward less what the ensemble's
    predictor skips: the ViT side's stage 3, conv stem, decoder and heads,
    and the two deep-supervision heads."""
    full = flops.count_model_flops(_port_model("ctunet"), 1, roi=ROI)
    res = flops.count_model_flops(_port_model("ctunet"), 1, res_only=True, roi=ROI)
    skipped = ("vit_encoder.layers.3.", "vit_encoder0.", "vit_decoder0.", "vit_out.",
               "decoder_linear_96x96.", "res_out_48x48.", "res_out_24x24.")
    assert sum(res.values()) < sum(full.values())
    assert res == {k: v for k, v in full.items() if not k.startswith(skipped)}


def test_jax_walk_counts_a_pallas_body_once():
    """C11: ``_walk`` counts a ``pallas_call`` body once, not once per grid
    step. The JAX tool runs on the TPU, where the pixelweight fusion is a
    Pallas kernel (tile 512 rows), so its count holds one tile of each
    call's projections; the plain composition holds them all (4 QKV + out
    products, 14 N C^2, the cross-dots being elementwise sums)."""
    from hybrid_ctunet_tpu.ops.pixelweight import PixelweightParams, pixelweight_attention

    C, n = 128, 16 ** 3
    p = PixelweightParams(*(jax.ShapeDtypeStruct(s, jnp.float32)
                            for s in [(C,)] * 4 + [(C, 3 * C)] * 2 + [(C, C)]))
    x = jax.ShapeDtypeStruct((1, 16, 16, 16, C), jnp.float32)
    counts = {}
    for use_pallas in (False, True):
        jaxpr = jax.make_jaxpr(
            lambda a, b, q: pixelweight_attention(a, b, q, use_pallas=use_pallas))(x, x, p)
        acc = defaultdict(int)
        MFU._walk(jaxpr.jaxpr, 1, acc, "")
        counts[use_pallas] = sum(acc.values())
    assert counts[False] == 14 * n * C * C
    assert counts[True] < counts[False] * 512 / n * 1.05  # one 512-row tile's worth


def test_count_needs_the_meta_device():
    with pytest.raises(ValueError, match="meta"):
        flops.count_model_flops(TUNet(dtype=torch.float32, **TINY), 1, roi=ROI)

