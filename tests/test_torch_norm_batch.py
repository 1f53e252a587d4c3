"""BatchNorm (``--norm_name batch``, ROADMAP A13) in the port against the JAX
package's ``TorchBatchNorm`` (the oracle pattern of tests/test_norm_batch.py).

Tolerances: the op alone in fp32 to 1e-5 (outputs and buffers over three
train-mode forwards, then eval mode, and the backward through its
recompute: the gradients of x, the scale and the bias), as the JAX test
holds it to torch;
TINY CUNet (depth 50) and TINY TUNet at 32^3 in fp32: the TUNet heads to
1e-4 of the max, the CUNet heads to 1e-3 of the max (ROADMAP C5: the deep
ResNet stages normalize over few values); one AdamW step at lr 1e-4: the
loss to rtol 1e-4, the running buffers to 1e-4 (relative and absolute), the
parameters to 2.5e-4 (the JAX DP tests' Adam-noise bound at lr 1e-3,
scaled to the lr), and each parameter's gradient against JAX's: its norm
to rtol 1e-2 (tests/test_torch_train.py's gradient tolerance) and its
direction to a relative L2 error of 0.1 (fp32 gradients of the first
stages differ from JAX's by a few percent elementwise, ROADMAP C5; a
flipped sign gives 2). The converters consume every parameter and statistic;
the instance-norm models' state-dict keys are those of the previous
release; a checkpoint keeps the buffers."""
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.models import CUNet as JCUNet
from hybrid_ctunet_tpu.models import TUNet as JTUNet
from hybrid_ctunet_tpu.ops.norm import TorchBatchNorm
from hybrid_ctunet_tpu.train import state as jstate
from hybrid_ctunet_tpu.train import steps as jsteps
from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, TUNet
from hybrid_ctunet_tpu_torch.models.layers import ConvNorm
from hybrid_ctunet_tpu_torch.train import state, steps
from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights, save_checkpoint
from hybrid_ctunet_tpu_torch.utils.params import (
    cunet_state_dict_from_jax, load_numpy_state_dict, random_init_, tunet_state_dict_from_jax,
)

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
JAX_PLAIN = dict(ZFOLD="0", ALTFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
                 PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0", PALLAS_SHUFFLE="0",
                 TRANSP_PALLAS="0")


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


def _random_stats(rng, path, shape):
    """Running buffers away from their init: means N(0, 0.1), variances in
    [0.5, 1.5]."""
    if path[-1].key == "mean":
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


def _jax_variables(model, rng, x):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map_with_path(lambda p, s: _random_leaf(rng, p, s.shape),
                                              shapes["params"])
    stats = jax.tree_util.tree_map_with_path(lambda p, s: _random_stats(rng, p, s.shape),
                                             shapes["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _size(tree):
    return sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(tree))


def test_batchnorm_op_matches_jax():
    """Three train-mode forwards of one batch (outputs, then the running
    buffers) and an eval-mode forward, against the JAX TorchBatchNorm."""
    x = np.random.default_rng(0).standard_normal((2, 4, 5, 3, 6)).astype(np.float32) * 2 + 1
    mod = TorchBatchNorm()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": np.linspace(0.5, 1.5, 6, dtype=np.float32),
              "bias": np.linspace(-0.2, 0.3, 6, dtype=np.float32)}
    bs = variables["batch_stats"]
    norm = ConvNorm(6, "batch").train()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(params["scale"]))
        norm.bias.copy_(torch.from_numpy(params["bias"]))
    for _ in range(3):
        want, upd = mod.apply({"params": params, "batch_stats": bs}, jnp.asarray(x),
                              mutable=["batch_stats"])
        bs = upd["batch_stats"]
        with torch.no_grad():
            got = norm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(bs["mean"]), atol=1e-5)
    np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(bs["var"]), atol=1e-5)
    assert int(norm.num_batches_tracked) == 3
    want = mod.apply({"params": params, "batch_stats": bs}, jnp.asarray(x))
    with torch.no_grad():
        got = norm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    # the train-mode backward (recomputed from x) against jax.grad
    dy = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, _ = mod.apply({"params": p, "batch_stats": bs}, x, mutable=["batch_stats"])
        return jnp.sum(y * dy)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (norm.train()(xt) * torch.from_numpy(dy)).sum().backward()
    for got, want in ((xt.grad, want_x), (norm.weight.grad, want_p["scale"]),
                      (norm.bias.grad, want_p["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cunet_case():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)
    jmodel = JCUNet(out_channels=3, model_depth=50, norm_name="batch")
    return jmodel, _jax_variables(jmodel, rng, x[:1]), x, y


def _port_cunet(variables):
    model = CUNet(out_channels=3, model_depth=50, norm_name="batch")
    load_numpy_state_dict(model, cunet_state_dict_from_jax(variables))
    return model


def test_cunet_forward_matches_jax(cunet_case):
    """TINY CUNet (depth 50, 32^3, fp32) with BatchNorm in eval mode, on
    the running buffers, against the JAX apply (immutable). Train mode is
    the step test's."""
    jmodel, variables, x, _ = cunet_case
    model = _port_cunet(variables)
    with flags.override(**JAX_PLAIN):
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3 * np.abs(w).max(), rtol=1e-3)


def test_cunet_train_step_matches_jax(cunet_case):
    """One fp32 AdamW step of the TINY CUNet with BatchNorm: the JAX
    ``make_train_step`` (batch_stats folded into the state) and the port's:
    loss, running buffers, parameters, and the step's gradients against
    JAX's ``compute_grads`` (``mutable=["batch_stats"]``)."""
    jmodel, variables, x, y = cunet_case
    jst = jstate.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                   tx=jstate.make_optimizer("adamw", reg_weight=1e-5),
                                   batch_stats=variables["batch_stats"])
    with flags.override(**JAX_PLAIN):
        jgrads = jax.jit(lambda st, x, y: jsteps.compute_grads(
            jsteps.LOSS_FNS["cunet"], st, x, y, smooth_nr=0.0, smooth_dr=1e-6)[2])(
            jst, jnp.asarray(x), jnp.asarray(y))
        jst, jm = jax.jit(jsteps.make_train_step("cunet"))(jst, jnp.asarray(x), jnp.asarray(y),
                                                           1e-4)
    model = _port_cunet(variables).train()
    step = steps.make_train_step("cunet", model,
                                 state.make_optimizer(model.parameters(), "adamw",
                                                      reg_weight=1e-5))
    m = step(torch.from_numpy(x), torch.from_numpy(y), 1e-4)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    want = cunet_state_dict_from_jax(jax.device_get({"params": jst.params,
                                                     "batch_stats": jst.batch_stats}))
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], atol=2.5e-4, rtol=0, err_msg=k)
    want_grad = cunet_state_dict_from_jax(jax.device_get(
        {"params": jgrads, "batch_stats": variables["batch_stats"]}))
    grads = dict(model.named_parameters())
    assert set(grads) <= set(want_grad)
    for k in grads:
        g, w = grads[k].grad.numpy().astype(np.float64), want_grad[k]
        scale = np.linalg.norm(w)
        ratio, err = np.linalg.norm(g) / scale, np.linalg.norm(g - w) / scale
        assert abs(ratio - 1.0) <= 1e-2 and err <= 0.1, \
            f"{k}: gradient norm ratio {ratio:.4g}, relative L2 error {err:.3g}"


def test_tunet_forward_matches_jax():
    """TINY TUNet with BatchNorm in its conv stem and decoder (fp32, 1e-4 of
    the max), eval and train mode."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    jmodel = JTUNet(**TINY, norm_name="batch")
    variables = _jax_variables(jmodel, rng, x[:1])
    model = TUNet(**TINY, norm_name="batch")
    load_numpy_state_dict(model, tunet_state_dict_from_jax(variables))
    want_eval = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    want_train, _ = jax.jit(lambda v, x: jmodel.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


@pytest.mark.parametrize("name", ["cunet", "tunet"])
def test_converters_consume_every_value(name, cunet_case):
    """Every JAX parameter and running statistic lands in the state dict
    (the values the converter wrote add up to the JAX trees' sizes; the
    ``num_batches_tracked`` counts aside), and it loads strictly."""
    if name == "cunet":
        _, variables, _, _ = cunet_case
        sd = cunet_state_dict_from_jax(variables)
        model = CUNet(out_channels=3, model_depth=50, norm_name="batch")
    else:
        jmodel = JTUNet(**TINY, norm_name="batch")
        variables = _jax_variables(jmodel, np.random.default_rng(3),
                                   np.zeros((1, 32, 32, 32, 1), np.float32))
        sd = tunet_state_dict_from_jax(variables)
        model = TUNet(**TINY, norm_name="batch")
    written = sum(v.size for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    assert written == _size(variables["params"]) + _size(variables["batch_stats"])
    load_numpy_state_dict(model, sd)


# sha256 of the sorted (key, shape) lists of the instance-norm models' state
# dicts at full width (CTUNet depth 101, CUNet depth 101, TUNet; pf 8), as
# the previous release built them
INSTANCE_KEYS = {"ct101": (405, "c498d92590da9149"), "cu101": (125, "342fbd0a2c74bea8"),
                 "tu": (235, "1c09a92a44af6417")}


def test_instance_norm_keys_unchanged():
    """The instance-norm models own no norm state: their keys (and shapes)
    are the previous release's, so its checkpoints and the reference's load."""
    for name, model in (("ct101", CTUNet(model_depth=101, patch_frame=8, device="meta")),
                        ("cu101", CUNet(model_depth=101, device="meta")),
                        ("tu", TUNet(patch_frame=8, device="meta"))):
        keys = sorted([k, list(v.shape)] for k, v in model.state_dict().items())
        digest = hashlib.sha256(json.dumps(keys).encode()).hexdigest()[:16]
        assert (len(keys), digest) == INSTANCE_KEYS[name], name


def test_checkpoint_keeps_the_buffers(tmp_path):
    """A BatchNorm CUNet after a train-mode forward: its running buffers
    and counts survive save_checkpoint / load_weights."""
    model = random_init_(CUNet(out_channels=3, model_depth=50, norm_name="batch"), 4)
    with torch.no_grad():
        model.train()(torch.randn(1, 32, 32, 32, 1, generator=torch.Generator().manual_seed(0)))
    path = save_checkpoint(str(tmp_path), "model_res.pt", model,
                           state.make_optimizer(model.parameters()), epoch=1, best_acc=0.5)
    fresh = CUNet(out_channels=3, model_depth=50, norm_name="batch")
    load_weights(fresh, path)
    got, want = fresh.state_dict(), model.state_dict()
    assert any(k.endswith("running_var") for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert int(got["convnet.norm1.num_batches_tracked"]) == 1
    assert not torch.equal(got["convnet.norm1.running_mean"], torch.zeros(64))
