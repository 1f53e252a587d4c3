"""The port's training path against the JAX package's: DiceCE and the
deep-supervision losses (1e-6), the label downscale (exact), the LR
schedules over epochs 0-60 (1e-7), the optimizers, three fp32 AdamW steps of
the TINY TUNet from one init (losses 1e-4 relative, params 1e-3), one TINY
CTUNet step (loss 1e-3 relative, per-module gradient norms 1e-2: the deep
ResNet stages normalize over few voxels at 32^3, ROADMAP C5), exact
gradient accumulation, and the training CLI end to end on the CPU, its
checkpoint read by the JAX package."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.models import CTUNet as JCTUNet
from hybrid_ctunet_tpu.models import CUNet as JCUNet
from hybrid_ctunet_tpu.models import TUNet as JTUNet
from hybrid_ctunet_tpu.ops import losses as jlosses
from hybrid_ctunet_tpu.ops.resize import downscale_labels as jdownscale
from hybrid_ctunet_tpu.train import schedule as jschedule
from hybrid_ctunet_tpu.train import state as jstate
from hybrid_ctunet_tpu.train import steps as jsteps
from hybrid_ctunet_tpu.train.checkpoint import load_params_from_torch
from hybrid_ctunet_tpu_torch.cli import factory, train_main
from hybrid_ctunet_tpu_torch.cli.args import build_train_parser
from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, TUNet
from hybrid_ctunet_tpu_torch.ops import losses
from hybrid_ctunet_tpu_torch.ops.resize import downscale_labels
from hybrid_ctunet_tpu_torch.train import schedule, state, steps
from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights, save_checkpoint
from hybrid_ctunet_tpu_torch.utils.params import (
    ctunet_state_dict_from_jax, load_numpy_state_dict, tunet_state_dict_from_jax,
)

# tests/test_models.py TINY
TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
# the JAX package's plain layouts for the ResNet models: its TPU rewrites
# (z-folds, Pallas kernels in interpret mode) are the same math and take
# twice as long to compile on the CPU
JAX_PLAIN = dict(ZFOLD="0", ALTFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
                 PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0", PALLAS_SHUFFLE="0",
                 TRANSP_PALLAS="0")


def _random_leaf(rng, path, shape):
    """The JAX package's init scales: conv kernels N(0, 2/fan_in), Linear
    N(0, 1/fan_in), LN scales 1 + noise, biases small, tables N(0, 1)."""
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


def _jax_params(model, rng, x):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape), shapes)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def heads():
    rng = np.random.default_rng(0)
    res = [rng.standard_normal(s).astype(np.float32)
           for s in [(2, 8, 8, 8, 5), (2, 4, 4, 8, 5), (2, 2, 2, 4, 5)]]
    vit = [rng.standard_normal((2, 8, 8, 8, 5)).astype(np.float32) for _ in range(2)]
    label = rng.integers(0, 5, (2, 8, 8, 8, 1))
    return res, vit, label


def test_dice_ce_matches_jax(heads):
    (logits, *_), _, label = heads
    for fn in ("dice_loss", "softmax_cross_entropy", "dice_ce_loss"):
        got = getattr(losses, fn)(_t(logits), _t(label)).item()
        want = float(getattr(jlosses, fn)(jnp.asarray(logits), jnp.asarray(label)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
    got = losses.dice_loss(_t(logits).bfloat16(), _t(label[..., 0]), squared_pred=False,
                           smooth_nr=1e-5)
    want = jlosses.dice_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(label[..., 0]),
                             squared_pred=False, smooth_nr=1e-5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_model_losses_match_jax(heads):
    """CUNet's deep supervision, TUNet's two heads and CTUNet's
    loss1 + 0.5 loss2, with the aux terms."""
    res, vit, label = heads
    r, v, lb = [_t(a) for a in res], [_t(a) for a in vit], _t(label)
    jr, jv, jl = [jnp.asarray(a) for a in res], [jnp.asarray(a) for a in vit], jnp.asarray(label)
    total, aux = steps.ctunet_loss_fn((r, v), lb)
    jtotal, jaux = jsteps.ctunet_loss_fn((jr, jv), jl)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    for k in ("loss1", "loss2"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-6)
    np.testing.assert_allclose(steps.cunet_loss_fn(r, lb)[0].item(),
                               float(jsteps.cunet_loss_fn(jr, jl)[0]), rtol=1e-6)
    np.testing.assert_allclose(steps.tunet_loss_fn(v, lb)[0].item(),
                               float(jsteps.tunet_loss_fn(jv, jl)[0]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 1), (1, 9, 7, 5), (1, 96, 96, 96, 1)])
@pytest.mark.parametrize("zoom", [(0.5, 0.5, 1.0), (0.25, 0.25, 0.5)])
def test_downscale_labels_exact(shape, zoom):
    lab = np.random.default_rng(1).integers(0, 14, shape).astype(np.uint8)
    got = downscale_labels(_t(lab), zoom).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdownscale(jnp.asarray(lab), zoom)))


@pytest.mark.parametrize("name", ["warmup_cosine", "cosine_anneal", "constant"])
def test_schedules_match_jax(name):
    kw = dict(base_lr=1e-4, warmup_epochs=10, max_epochs=60)
    got, want = schedule.make_epoch_schedule(name, **kw), jschedule.make_epoch_schedule(name, **kw)
    for epoch in range(61):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), atol=1e-7, rtol=0)
    assert schedule.warmup_cosine_lr(9, **kw) == pytest.approx(1e-4)  # base LR at warmup - 1


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizers_match_optax(name):
    """Three updates of each optimizer on one quadratic: torch's against the
    JAX package's optax chain."""
    rng = np.random.default_rng(2)
    p0, target = rng.standard_normal(7).astype(np.float32), rng.standard_normal(7).astype(np.float32)
    p = torch.nn.Parameter(_t(p0.copy()))
    opt = state.make_optimizer([p], name, reg_weight=1e-2, momentum=0.9)
    tx = jstate.make_optimizer(name, reg_weight=1e-2, momentum=0.9)
    jp, js = jnp.asarray(p0), None
    js = tx.init(jp)
    for lr in (1e-2, 5e-3, 2e-3):
        opt.zero_grad()
        ((p - _t(target)) ** 2).sum().backward()
        state.set_learning_rate(opt, lr)
        opt.step()
        g = jax.grad(lambda q: jnp.sum((q - target) ** 2))(jp)
        js.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)


def test_tunet_adamw_steps_match_jax():
    """Three fp32 AdamW steps of the TINY TUNet from the same init: the JAX
    ``make_train_step`` and the port's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)
    jmodel = JTUNet(**TINY)
    params = _jax_params(jmodel, rng, x[:1])
    jst = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                   tx=jstate.make_optimizer("adamw", reg_weight=1e-5))
    jstep = jax.jit(jsteps.make_train_step("tunet"))

    model = TUNet(**TINY)
    load_numpy_state_dict(model, tunet_state_dict_from_jax({"params": params}))
    step = steps.make_train_step("tunet", model,
                                 state.make_optimizer(model.parameters(), "adamw",
                                                      reg_weight=1e-5))
    for lr in (1e-4, 1e-4, 5e-5):
        jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y), lr)
        m = step(_t(x), _t(y), lr)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    want = tunet_state_dict_from_jax({"params": jax.device_get(jst.params)})
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-3, err_msg=k)


def _top_norms(named):
    """Gradient norm per top-level module."""
    sq = {}
    for k, g in named:
        top = k.split(".")[0]
        sq[top] = sq.get(top, 0.0) + float(np.sum(np.square(np.asarray(g, np.float64))))
    return {k: np.sqrt(v) for k, v in sq.items()}


def test_ctunet_step_matches_jax():
    """One TINY CTUNet (depth 50, 32^3) step: the loss, and each top-level
    module's gradient norm, against ``jax.value_and_grad`` of the JAX loss."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (1, 32, 32, 32, 1)).astype(np.int32)
    jmodel = JCTUNet(model_depth=50, **TINY)
    params = _jax_params(jmodel, rng, x)

    def jloss(p):
        return jsteps.ctunet_loss_fn(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))[0]

    with flags.override(**JAX_PLAIN):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    model = CTUNet(model_depth=50, **TINY)
    load_numpy_state_dict(model, ctunet_state_dict_from_jax({"params": params}))
    loss, _ = steps.ctunet_loss_fn(model(_t(x)), _t(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    got = _top_norms((k, p.grad.numpy()) for k, p in model.named_parameters())
    want = _top_norms(ctunet_state_dict_from_jax({"params": jax.device_get(jg)}).items())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


class _ThreeHeads(torch.nn.Module):
    """CUNet's output contract (full, 1/2, 1/4) from one 1x1x1 layer."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(1, 3)

    def forward(self, x):
        full = torch.tanh(self.lin(x))
        return full, full[:, ::2, ::2, :], full[:, ::4, ::4, ::2]


def test_grad_accum_is_exact():
    """Four microbatches of one and one batch of four give the same update."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 8, 8, 8, 1, generator=gen)
    y = torch.randint(0, 3, (4, 8, 8, 8, 1), generator=gen)
    out = []
    for accum in (1, 4):
        torch.manual_seed(0)
        model = _ThreeHeads()
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        m = steps.make_train_step("cunet", model, opt, grad_accum=accum)(x, y, 0.1)
        out.append((m["loss"], [p.detach().clone() for p in model.parameters()]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class _OneBatch:
    """A train loader of one (image, label) batch, as ``TrainLoader`` yields."""

    def __init__(self, image, label):
        self.batch = (image, label)

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 1

    def __iter__(self):
        return iter([self.batch])


def test_train_step_in_train_mode_and_validation_in_eval_mode(tmp_path):
    """ROADMAP C7: ``run_training`` runs its train steps in train mode and
    ``val_epoch`` in eval mode, leaving the model in the mode it found. A
    forward hook on every module of the TINY TUNet records its ``training``
    flag in each pass; validation is the pass under inference mode."""
    from hybrid_ctunet_tpu_torch.data.transforms import preprocess_case
    from hybrid_ctunet_tpu_torch.train import trainer

    rng = np.random.default_rng(7)
    image = rng.uniform(-175, 250, (32, 32, 32)).astype(np.float32)
    label = rng.integers(0, 3, (32, 32, 32)).astype(np.int32)
    img, lab, meta = preprocess_case(image, np.diag([1.5, 1.5, 2.0, 1.0]), label,
                                     resample_labels=False)
    case = trainer.ValCase(image=img, label=lab, meta=meta)
    torch.manual_seed(0)
    model = TUNet(**TINY).eval()  # the wrong mode for training: run_training must set it
    seen = {True: set(), False: set()}  # inference mode -> training flags seen
    for m in model.modules():
        m.register_forward_hook(
            lambda m, i, o: seen[torch.is_inference_mode_enabled()].add(m.training))
    cfg = trainer.TrainConfig(model_name="tunet", max_epochs=1, warmup_epochs=0, val_every=1,
                              lrschedule="constant", roi_size=(32, 32, 32), sw_batch_size=1,
                              infer_overlap=0.0, logdir=str(tmp_path), out_channels=3,
                              save_checkpoint=False)
    step = steps.make_train_step("tunet", model, state.make_optimizer(model.parameters(), "adamw"))
    batch = _OneBatch(rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32),
                      rng.integers(0, 3, (1, 32, 32, 32, 1)).astype(np.int32))
    trainer.run_training(model, None, step, batch, [case], cfg, device="cpu")
    assert seen == {False: {True}, True: {False}}
    assert model.training  # validation restored the train mode it found
    engine = trainer.make_val_engine(model, cfg, dual_output=False)
    model.eval()
    trainer.val_epoch(model, engine, [case], cfg, dual_output=False, device="cpu")
    assert not model.training


def test_checkpoint_round_trip(tmp_path):
    """The reference's dict; weights and optimizer state load back."""
    model = CUNet(out_channels=3, model_depth=50)
    factory.random_init_(model, 1)
    opt = state.make_optimizer(model.parameters(), "adamw")
    path = save_checkpoint(str(tmp_path), "model_res.pt", model, opt, epoch=3, best_acc=0.25)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert set(raw) == {"epoch", "best_acc", "state_dict", "optimizer"}
    fresh = CUNet(out_channels=3, model_depth=50)
    ckpt = load_weights(fresh, path)
    assert ckpt["epoch"] == 3 and ckpt["best_acc"] == 0.25
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k


def test_train_cli_end_to_end(tmp_path):
    """main_C_TUNet's entry with --model_name cunet on the CPU: one epoch, a
    validation pass, ``model_res.pt`` and ``latest.pt``; the JAX package
    reads the checkpoint and its forward on a 32^3 input equals the port's
    (1e-3 of the max, ROADMAP C5: at the 32x32x16 training ROI the ResNet's
    stage 4 would normalize over 8 voxels)."""
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    best = train_main.main("c_tunet", [
        "--device", "cpu", "--synthetic", "--model_name", "cunet", "--model_depths", "50",
        "--roi_x", "32", "--roi_y", "32", "--roi_z", "16", "--out_channels", "3",
        "--max_epochs", "1", "--val_every", "1", "--save_checkpoint", "--noamp",
        "--infer_overlap", "0", "--data_dir", data, "--logdir", logs])
    assert best["acc"] > 0
    assert {"model_res.pt", "latest.pt", "scalars.jsonl"} <= set(os.listdir(logs))
    path = os.path.join(logs, "model_res.pt")
    model = CUNet(out_channels=3, model_depth=50)
    load_weights(model, path)
    x = np.random.default_rng(6).standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    with torch.inference_mode():
        got = model(_t(x))[0].numpy()
    jparams = load_params_from_torch(path, "cunet", model_depth=50)
    with flags.override(**JAX_PLAIN):
        want = np.asarray(JCUNet(out_channels=3, model_depth=50).apply(jparams, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(), rtol=1e-3)


def _rates(model):
    """The dropout rates of the sites; the fusions' pixelweight sites keep
    0, as no CTUNet caller sets their rate."""
    from hybrid_ctunet_tpu_torch.models.layers import Dropout

    return {m.rate for n, m in model.named_modules()
            if isinstance(m, Dropout) and "pixelweight" not in n}


def _norms(model):
    from hybrid_ctunet_tpu_torch.models.layers import ConvNorm

    return {(m.kind, m.sync) for m in model.modules() if isinstance(m, ConvNorm)}


@pytest.mark.parametrize("flags,expect", [
    (["--dropout_rate", "0.2"], lambda m: _rates(m) == {0.2}),
    (["--norm_name", "batch"], lambda m: _norms(m) == {("batch", False)}),
    (["--distributed", "--world_size", "2", "--norm_name", "batch"],
     lambda m: _norms(m) == {("batch", True)} and _rates(m) == {0.0}),
    (["--resume_jit"], "TorchScript"),
    ([], "--device cpu"),
])
def test_cli_refuses_what_it_lacks(flags, expect):
    """--dropout_rate, --norm_name batch and --distributed are accepted and
    reach the model: ``build_model`` sets the dropout rate of every site,
    BatchNorm at every conv-path norm, and SyncBatchNorm in a world of more
    than one process. --resume_jit exits (as in the JAX package); without a
    card the entry point refuses unless --device cpu is given."""
    if not flags and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = build_train_parser("ctunet").parse_args(flags)
    if isinstance(expect, str):
        with pytest.raises(SystemExit, match=expect):
            factory.check_supported(args)
            factory.select_device(args)
        return
    factory.check_supported(args)
    args.model_name = "ctunet"
    for k, v in dict(roi_x=32, roi_y=32, roi_z=32, out_channels=3, hidden_size=64,
                     num_depths=1, mlp_dim=128, num_heads=2, feature_size=16,
                     window=2).items():
        setattr(args, k, v)
    assert expect(factory.build_model(args, torch.device("cpu")))
