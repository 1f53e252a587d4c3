"""Dropout (ROADMAP A12) in the port against the JAX package's.

Masks cannot equal JAX's (two RNGs), but rate 1.0 is deterministic in both
(flax ``nn.Dropout`` and the port give zeros), so at rate 1.0 each site
module in train mode, and a TINY TUNet and CTUNet, are held to the JAX
module applied with ``deterministic=False``: site modules in fp32 to 1e-6
(absolute), the TUNet heads to 1e-4 and the CTUNet res heads to 1e-3 of the
output's max (ROADMAP C5). Since rate 1.0 zeroes a site's output whatever
the inner mask, each placement is pinned at rate 0.5 too: both libraries'
draws are replaced by one seeded uniform sequence, so that equal draw
shapes in equal order give equal masks; each site, and the TINY TUNet and
CTUNet, then match JAX to the same tolerances (site modules 1e-5 of the
output's max: the outputs are no longer zeros). Rate 0 in train mode and rate 0.2 in eval mode
give the rate-0 eval output bit for bit. At 0.2 a seeded generator keeps
0.8 of the values (within 0.005 over 2^20 draws) scaled by exactly 1/0.8;
the train step draws distinct masks per step, per microbatch and per rank,
the same ones again from the same seed. The training CLI runs end to end
with ``--dropout_rate 0.2`` on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.models import CTUNet as JCTUNet
from hybrid_ctunet_tpu.models import TUNet as JTUNet
from hybrid_ctunet_tpu.models.layers import FeedForward as JFeedForward
from hybrid_ctunet_tpu.models.layers import MultiAxisWindowAttention as JWindowAttention
from hybrid_ctunet_tpu.models.layers import PixelweightFusion as JPixelweight
from hybrid_ctunet_tpu.models.vit3d import TransformerBlock as JTransformerBlock
from hybrid_ctunet_tpu.models.vit3d import ViTAttention as JViTAttention
from hybrid_ctunet_tpu_torch.cli import train_main
from hybrid_ctunet_tpu_torch.data.synthetic import write_synthetic_dataset
from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet
from hybrid_ctunet_tpu_torch.models.layers import (
    Dropout, FeedForward, MultiAxisWindowAttention, PixelweightFusion, set_dropout_generator,
)
from hybrid_ctunet_tpu_torch.models.vit3d import TransformerBlock, ViTAttention
from hybrid_ctunet_tpu_torch.ops import dropout as dropout_ops
from hybrid_ctunet_tpu_torch.train import steps
from hybrid_ctunet_tpu_torch.utils.params import (
    _Out, ctunet_state_dict_from_jax, load_numpy_state_dict, tunet_state_dict_from_jax,
)

# tests/test_models.py TINY
TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
# the JAX package's plain layouts (tests/test_torch_train.py)
JAX_PLAIN = dict(ZFOLD="0", ALTFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
                 PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0", PALLAS_SHUFFLE="0",
                 TRANSP_PALLAS="0")
SITE_TOL = 1e-6


def _random_leaf(rng, path, shape):
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


def _jax_train(module, rng, *xs):
    """Random parameters and the module applied in train mode (dropout
    active) to ``xs``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, xs))["params"]
    params = jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape), shapes)
    out = jax.jit(lambda p, *xs: module.apply({"params": p}, *xs, deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(1)}))(
        params, *map(jnp.asarray, xs))
    return params, jax.tree_util.tree_map(np.asarray, out)


def _site(name, rng):
    """(port module, JAX module, inputs, state dict from the JAX params)."""
    x = rng.standard_normal((1, 4, 4, 4, 64)).astype(np.float32)
    if name == "ffn":
        return (FeedForward(64, 128, dropout=1.0), JFeedForward(hidden_dim=128, dropout=1.0),
                (x,), lambda out, p: out.ffn("m", p))
    if name in ("block_attn", "grid_attn"):
        grid = name == "grid_attn"
        return (MultiAxisWindowAttention(64, 2, grid=grid, dropout=1.0),
                JWindowAttention(window=2, grid=grid, dropout=1.0), (x,),
                lambda out, p: out.window_attn("m", p))
    if name == "pixelweight":
        x2 = rng.standard_normal(x.shape).astype(np.float32)
        return (PixelweightFusion(64, dropout=1.0), JPixelweight(dropout=1.0), (x, x2),
                lambda out, p: out.pixelweight("m", p))
    t = rng.standard_normal((2, 8, 64)).astype(np.float32)

    def vit_attn(out, p, dst="m"):
        out.ln(f"{dst}.norm", p["norm"])
        out.dense(f"{dst}.to_qkv", p["to_qkv"])
        out.dense(f"{dst}.to_out.0", p["to_out"])

    if name == "vit_block":
        def vit_block(out, p):
            vit_attn(out, p["attn"], "m.attn")
            out.ffn("m.ff", p["ff"])

        return (TransformerBlock(64, 2, 32, 128, dropout=1.0),
                JTransformerBlock(heads=2, dim_head=32, mlp_dim=128, dropout=1.0), (t,),
                vit_block)
    return (ViTAttention(64, heads=2, dim_head=32, dropout=1.0),
            JViTAttention(heads=2, dim_head=32, dropout=1.0), (t,), vit_attn)


@pytest.mark.parametrize("name", ["ffn", "block_attn", "grid_attn", "pixelweight", "vit_attn"])
def test_site_at_rate_one_matches_jax(name):
    """Each dropout site module in train mode at rate 1.0 against the JAX
    module with ``deterministic=False`` (fp32, 1e-6); each draws its two
    masks (counted)."""
    rng = np.random.default_rng(0)
    port, jmod, xs, convert = _site(name, rng)
    params, want = _jax_train(jmod, rng, *xs)
    out = _Out()
    convert(out, params)
    load_numpy_state_dict(port, {k[2:]: v for k, v in out.sd.items()})
    calls = []
    real = dropout_ops.dropout

    def spy(x, rate, generator):
        calls.append(tuple(x.shape))
        return real(x, rate, generator)

    dropout_ops.dropout = spy
    try:
        with torch.no_grad():
            got = port.train()(*map(torch.from_numpy, xs))
    finally:
        dropout_ops.dropout = real
    assert len(calls) == 2, calls
    np.testing.assert_allclose(got.numpy(), want, atol=SITE_TOL, rtol=0)


def _models(rng, x, dropout_rate):
    """A TINY TUNet and CTUNet (depth 50) of the port at ``dropout_rate``
    with the weights of the JAX ones; the JAX ones' train-mode outputs at
    rate 1.0."""
    out = {}
    for name, jcls, cls, conv, kw in (
            ("tunet", JTUNet, TUNet, tunet_state_dict_from_jax, {}),
            ("ctunet", JCTUNet, CTUNet, ctunet_state_dict_from_jax, dict(model_depth=50))):
        with flags.override(**JAX_PLAIN):
            params, want = _jax_train(jcls(**TINY, dropout_rate=1.0, **kw), rng, x)
        model = cls(**TINY, dropout_rate=dropout_rate, **kw)
        load_numpy_state_dict(model, conv({"params": params}))
        out[name] = (model, want, (jcls, kw, params))
    return out


@pytest.fixture(scope="module")
def tiny_models():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    return x, _models(rng, x, 1.0)


def test_models_at_rate_one_match_jax(tiny_models):
    """TINY TUNet (both heads, 1e-4 of the max) and CTUNet (res heads 1e-3
    of the max, vit heads 1e-4) in train mode at rate 1.0 against the JAX
    models applied with ``deterministic=False``."""
    x, models = tiny_models
    with torch.no_grad():
        model, want, _ = models["tunet"]
        got_tunet = model.train()(torch.from_numpy(x))
        model, want_ctunet, _ = models["ctunet"]
        got_ctunet = model.train()(torch.from_numpy(x))
    _assert_heads(got_tunet, want, got_ctunet, want_ctunet)


def _assert_heads(got_tunet, want_tunet, got_ctunet, want_ctunet):
    """TUNet heads to 1e-4 of the max, CTUNet res heads 1e-3, vit heads
    1e-4 (ROADMAP C5)."""
    for g, w in zip(got_tunet, want_tunet):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)
    (got_res, got_vit), (want_res, want_vit) = got_ctunet, want_ctunet
    for g, w in zip(got_res, want_res):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3 * np.abs(w).max(), rtol=1e-3)
    for g, w in zip(got_vit, want_vit):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


class _SharedUniforms:
    """Both libraries' dropout draws taken from one seeded uniform sequence,
    in draw order: flax's ``random.bernoulli(key, keep, shape)`` gives
    U >= 1 - keep, and the port's ``torch.rand(shape)`` gives U, which its
    dropout keeps where U >= rate. Each side records its draw shapes.

    The JAX ViT runs its blocks under ``nn.scan``, whose body is traced
    (twice) and then run for every layer: a draw replaced by a constant
    there would give every layer one mask. The draws of the port's modules
    named in ``keep_all`` (run the port first) therefore keep every value
    on both sides; the ``vit_block`` site pins their placement."""

    def __init__(self, monkeypatch, keep_all=()):
        self.monkeypatch = monkeypatch
        self.shapes = {"jax": [], "port": []}
        self.keep_all, self.keep_all_draws, self.current = keep_all, set(), None

    def _draw(self, side, shape):
        i = len(self.shapes[side])
        self.shapes[side].append(tuple(int(d) for d in shape))
        if side == "port" and any(n in self.current for n in self.keep_all):
            self.keep_all_draws.add(i)
        u = self.rngs[side].random(shape)
        return np.ones(shape) if i in self.keep_all_draws else u

    def jax(self, fn, *args):
        self.rngs = {"jax": np.random.default_rng(11)}
        with self.monkeypatch.context() as m:
            m.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(
                self._draw("jax", shape) >= 1.0 - p))
            return jax.tree_util.tree_map(np.asarray, fn(*args))

    def port(self, module, *xs):
        self.rngs = {"port": np.random.default_rng(11)}
        for name, m in module.named_modules():
            if isinstance(m, Dropout):
                m.register_forward_pre_hook(lambda *_, name=name: setattr(self, "current", name))
        with self.monkeypatch.context() as m, torch.no_grad():
            m.setattr(torch, "rand", lambda shape, generator=None, device=None: torch.from_numpy(
                self._draw("port", shape)).to(device))
            return module.train()(*map(torch.from_numpy, xs))


def _jax_apply_train(module, params, *xs):
    return jax.jit(lambda p, *xs: module.apply({"params": p}, *xs, deterministic=False,
                                              rngs={"dropout": jax.random.PRNGKey(1)}))(
        params, *map(jnp.asarray, xs))


@pytest.mark.parametrize("name", ["ffn", "block_attn", "grid_attn", "pixelweight", "vit_attn",
                                  "vit_block"])
def test_site_masks_placed_as_jax(name, monkeypatch):
    """Each site module at rate 0.5 in train mode, both libraries drawing
    the same uniforms: the draws have JAX's shapes in JAX's order (the inner
    mask on the GELU output, the softmaxed scores or the 2-way weights, the
    outer on the site's output; a ViT block's attention, then its FFN), and
    the outputs match JAX's (fp32, 1e-5 of the max)."""
    rng = np.random.default_rng(0)
    port, jmod, xs, convert = _site(name, rng)
    params, _ = _jax_train(jmod, rng, *xs)
    out = _Out()
    convert(out, params)
    load_numpy_state_dict(port, {k[2:]: v for k, v in out.sd.items()})
    for m in port.modules():
        if isinstance(m, Dropout):
            m.rate = 0.5
    set_dropout_generator(port, torch.Generator())
    shared = _SharedUniforms(monkeypatch)
    got = shared.port(port, *xs)
    want = shared.jax(_jax_apply_train, jmod.clone(dropout=0.5), params, *xs)
    assert shared.shapes["port"] == shared.shapes["jax"]
    assert len(shared.shapes["jax"]) == (4 if name == "vit_block" else 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_models_masks_placed_as_jax(tiny_models, monkeypatch):
    """The TINY TUNet and CTUNet at rate 0.5 in train mode, both libraries
    drawing the same uniforms (the scanned ViT blocks' draws keeping every
    value): every site's draw in JAX's shape and order, and the heads
    within the rate-1.0 test's tolerances."""
    x, models = tiny_models
    got, want = {}, {}
    for name, (model, _, (jcls, kw, params)) in models.items():
        port = type(model)(**TINY, dropout_rate=0.5, **kw)
        port.load_state_dict(model.state_dict())
        set_dropout_generator(port, torch.Generator())
        shared = _SharedUniforms(monkeypatch, keep_all=("vit.transformer.",))
        got[name] = shared.port(port, x)
        with flags.override(**JAX_PLAIN):
            want[name] = shared.jax(_jax_apply_train, jcls(**TINY, dropout_rate=0.5, **kw),
                                    params, x)
        assert shared.shapes["port"] == shared.shapes["jax"], name
        assert len(shared.shapes["jax"]) - len(shared.keep_all_draws) > 20, name
    _assert_heads(got["tunet"], want["tunet"], got["ctunet"], want["ctunet"])


def test_rate_zero_and_eval_mode_are_the_plain_forward(tiny_models):
    """The TINY TUNet (every dropout site) at rate 0 in train mode, and at
    rate 0.2 and 1.0 in eval mode, equals the rate-0 eval-mode forward bit
    for bit (dropout is the identity there)."""
    x, models = tiny_models
    sd = models["tunet"][0].state_dict()
    outs = []
    for rate, train in ((0.0, False), (0.0, True), (0.2, False), (1.0, False)):
        model = TUNet(**TINY, dropout_rate=rate)
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(torch.utils._pytree.tree_leaves(model.train(train)(torch.from_numpy(x))))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_keep_fraction_and_scale():
    """At 0.2 a seeded generator keeps 0.8 of 2^20 values (within 0.005),
    each exactly x / 0.8 in the input's dtype; the same seed gives the same
    mask; rate 1.0 gives zeros."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand(1 << 20, dtype=torch.float32).add_(0.5).to(dtype)
        gen = torch.Generator().manual_seed(3)
        y = dropout_ops.dropout(x, 0.2, gen)
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.8) < 0.005
        assert torch.equal(y[kept], x[kept] / 0.8) and y.dtype == dtype
        assert torch.equal(dropout_ops.dropout(x, 0.2, torch.Generator().manual_seed(3)), y)
    assert torch.equal(dropout_ops.dropout(x, 1.0, None), torch.zeros_like(x))
    site = Dropout(0.2).train()
    with pytest.raises(RuntimeError, match="generator"):
        site(x)


class _DropHeads(torch.nn.Module):
    """CUNet's output contract from one 1x1x1 layer behind a dropout site,
    which records its masks."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(1, 3)
        self.drop = Dropout(0.5)
        self.masks = []
        self.drop.register_forward_hook(lambda m, i, o: self.masks.append(o != 0))

    def forward(self, x):
        full = torch.tanh(self.drop(self.lin(x)))
        return full, full[:, ::2, ::2, :], full[:, ::4, ::4, ::2]


def _masks(rank, n_steps=2, start_step=0):
    torch.manual_seed(0)
    model = _DropHeads()
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = steps.make_train_step("cunet", model, opt, grad_accum=2, rank=rank,
                                 start_step=start_step)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(2, 8, 8, 8, 1, generator=gen) + 0.5
    y = torch.randint(0, 3, (2, 8, 8, 8, 1), generator=gen)
    for _ in range(n_steps):
        step(x, y, 0.1)
    assert step.step == start_step + n_steps
    return model.masks


def test_masks_differ_per_step_microbatch_and_rank():
    """Two steps of two microbatches: four distinct masks; another rank
    draws four others; the same rank draws the same four again. A step
    resumed at step 1 (``start_step``) draws step 1's masks, not step 0's."""
    r0, r1, again = _masks(0), _masks(1), _masks(0)
    assert len(r0) == 4
    masks = r0 + r1
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j]), (i, j)
    for a, b in zip(r0, again):
        assert torch.equal(a, b)
    resumed = _masks(0, n_steps=1, start_step=1)
    for a, b in zip(resumed, r0[2:]):
        assert torch.equal(a, b)


def test_train_cli_with_dropout(tmp_path, monkeypatch):
    """``train_main --dropout_rate 0.2 --device cpu`` (main_C_TUNet's entry,
    the TINY TUNet): one epoch and a validation pass, checkpoints written,
    dropout drawn in the train steps. Resumed from ``latest.pt``
    (``--checkpoint``) for a second epoch, the train step counts on from the
    steps the first run took, so that its masks are new."""
    calls, train_steps = [], []
    real = dropout_ops.dropout
    monkeypatch.setattr(dropout_ops, "dropout",
                        lambda x, rate, gen: calls.append(rate) or real(x, rate, gen))
    real_step = train_main.make_train_step
    monkeypatch.setattr(train_main, "make_train_step", lambda *a, **kw: train_steps.append(
        real_step(*a, **kw)) or train_steps[-1])
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    json_list = os.path.basename(write_synthetic_dataset(data, shape=(48, 48, 40),
                                                         n_classes=3))
    argv = [
        "--device", "cpu", "--json_list", json_list, "--model_name", "tunet",
        "--dropout_rate", "0.2",
        "--roi_x", "32", "--roi_y", "32", "--roi_z", "32", "--out_channels", "3",
        "--hidden_size", "64", "--num_depths", "1", "--mlp_dim", "128", "--num_heads", "2",
        "--feature_size", "16", "--window", "2", "--max_epochs", "1", "--val_every", "1",
        "--save_checkpoint", "--noamp", "--infer_overlap", "0", "--data_dir", data,
        "--logdir", logs]
    best = train_main.main("c_tunet", argv)
    assert np.isfinite(best["acc"]) and "latest.pt" in os.listdir(logs)
    assert calls and set(calls) == {0.2}
    taken = train_steps[0].step
    assert taken > 0
    train_main.main("c_tunet", [*argv, "--max_epochs", "2",
                                "--checkpoint", os.path.join(logs, "latest.pt")])
    assert train_steps[1].step == 2 * taken
