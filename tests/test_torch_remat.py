"""Rematerialization in the port: ``models.layers.set_remat_blocks`` /
``maybe_remat`` at the JAX package's sites, and the train step's whole-forward
``remat``. TINY models (depth 50, 32^3, fp32) on the CPU.

- One train step with block remat equals the step without it, bit for bit
  (the loss, every gradient, every buffer), for CUNet, TUNet and CTUNet with
  instance norm, with ``--dropout_rate 0.2`` (TUNet and CTUNet: CUNet has no
  dropout site) and with BatchNorm; every mask the recompute draws equals
  its forward's, and the running buffers move once.
- The blocks that run again in the backward are exactly the JAX sites,
  each once.
- ``make_train_step(remat=True)`` against the JAX ``make_train_step("cunet",
  remat=True)``: the tolerance of ``tests/test_train.py::
  test_remat_step_matches_plain``.
- The switch: off restores the old behaviour; no gradient, no remat.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.models import CUNet as JCUNet
from hybrid_ctunet_tpu.train import state as jstate
from hybrid_ctunet_tpu.train import steps as jsteps
from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, TUNet
from hybrid_ctunet_tpu_torch.models import layers, resnet3d, vit3d
from hybrid_ctunet_tpu_torch.ops import dropout as dropout_ops
from hybrid_ctunet_tpu_torch.ops import recompute as recompute_ops
from hybrid_ctunet_tpu_torch.train import state, steps
from hybrid_ctunet_tpu_torch.utils.params import (
    cunet_state_dict_from_jax, load_numpy_state_dict, random_init_,
)
from test_torch_train import JAX_PLAIN, TINY, _jax_params
from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

MODELS = {"cunet": (CUNet, dict(out_channels=3, model_depth=50)),
          "tunet": (TUNet, TINY),
          "ctunet": (CTUNet, dict(model_depth=50, **TINY))}


@pytest.fixture(autouse=True)
def _remat_on():
    """Each test starts from the default, and leaves it."""
    layers.set_remat_blocks(True)
    yield
    layers.set_remat_blocks(True)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (1, 32, 32, 32, 1)).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _model(name, **kw):
    cls, base = MODELS[name]
    return random_init_(cls(**base, **kw), 0)


def _record_draws(monkeypatch):
    """Every dropout draw as (recomputing, generator state, keep mask),
    the mask drawn again from a copy of the generator's state."""
    draws = []
    real = dropout_ops.dropout

    def draw(x, rate, generator):
        copy_ = torch.Generator()
        copy_.set_state(generator.get_state())
        mask = torch.rand(x.shape, generator=copy_) >= rate
        draws.append((recompute_ops.recomputing(), generator.get_state(), mask))
        return real(x, rate, generator)

    monkeypatch.setattr(dropout_ops, "dropout", draw)
    return draws


def _step(model, name, x, y, enabled, **kw):
    """One AdamW step at lr 0 (the parameters stay; ``.grad`` holds the
    step's gradients) with block remat ``enabled``."""
    step = steps.make_train_step(name, model, state.make_optimizer(model.parameters(), "adamw"),
                                 **kw)
    with layers.remat_blocks(enabled):
        loss = step(x, y, 0.0)["loss"]
    return (loss, {k: p.grad for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()})


def _wrapped_sites(model):
    """The JAX package's remat sites, by module name: every ResBlock
    (decoder blocks and the TUNet stem), every ViT block, and the ResNet
    bottlenecks after each stage's first."""
    sites = set()
    for n, m in model.named_modules():
        if isinstance(m, (layers.ResBlock, vit3d.TransformerBlock)):
            sites.add(n)
        elif isinstance(m, resnet3d.Bottleneck) and not n.endswith(".0"):
            sites.add(n)
    return sites


CASES = [("cunet", {}), ("cunet", {"norm_name": "batch"}),
         ("tunet", {}), ("tunet", {"dropout_rate": 0.2}), ("tunet", {"norm_name": "batch"}),
         ("ctunet", {}), ("ctunet", {"dropout_rate": 0.2}), ("ctunet", {"norm_name": "batch"})]


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{list(k.values()) or 'instance'}"
                                                 for n, k in CASES])
def test_remat_step_equals_plain_step(name, kw, monkeypatch):
    x, y = _batch()
    base = _model(name, **kw)
    log = _record_draws(monkeypatch)
    got, draws, again = {}, {}, []
    for enabled in (True, False):
        model = copy.deepcopy(base)
        for n, m in model.named_modules():
            m.register_forward_pre_hook(
                lambda m, a, n=n: again.append(n) if recompute_ops.recomputing() else None)
        start = len(log)
        got[enabled] = _step(model, name, x, y, enabled)
        draws[enabled] = log[start:]
    # the modules run again in the backward, outermost first: the JAX sites, each once
    outer = sorted(n for n in set(again)
                   if not any(n.startswith(o + ".") for o in set(again) if o != n))
    assert outer == sorted(_wrapped_sites(base))
    assert [again.count(n) for n in outer] == [1] * len(outer)
    # ResBlocks + ViT blocks + tail bottlenecks ((3, 4, 6, 3) at depth 50)
    assert len(outer) == {"cunet": 4 + 0 + 12, "tunet": 2 + 2, "ctunet": 9 + 2 + 12}[name]
    (loss, grads, buffers), (loss0, grads0, buffers0) = got[True], got[False]
    assert torch.equal(loss, loss0)
    assert set(grads) == set(grads0)
    for k, g in grads0.items():
        assert g is not None and torch.equal(grads[k], g), k
    for k, b in buffers0.items():
        assert torch.equal(buffers[k], b), k
    if kw.get("norm_name") == "batch":
        moved = [k for k, b in base.named_buffers() if not torch.equal(b, buffers0[k])]
        assert len(moved) == len(buffers0)  # every buffer moved, once: equal to no remat's
        assert all(int(v) == 1 for k, v in buffers.items() if k.endswith("num_batches_tracked"))
    forward = [d for d in draws[True] if not d[0]]
    redrawn = [d for d in draws[True] if d[0]]
    assert len(forward) == len(draws[False])  # the forward draws what it draws without remat
    for (_, s, m), (_, s0, m0) in zip(forward, draws[False]):
        assert torch.equal(s, s0) and torch.equal(m, m0)
    if kw.get("dropout_rate"):
        # the ViT blocks' sites (attention scores, to_out, the FFN's two) draw again
        assert len(redrawn) == 4 * TINY["num_depths"]
        for _, s, m in redrawn:
            same = [fm for _, fs, fm in forward if torch.equal(fs, s)]
            assert len(same) == 1 and torch.equal(same[0], m)
    else:
        assert not draws[True]


def test_whole_forward_remat_matches_jax():
    """One fp32 AdamW step of the TINY CUNet with the whole forward
    rematerialized: the port's ``make_train_step(remat=True)`` against the
    JAX ``make_train_step("cunet", remat=True)`` (loss rtol 1e-6; the
    parameters atol 2.5e-3, rtol 1e-4, as ``tests/test_train.py::
    test_remat_step_matches_plain`` holds JAX's remat step to its plain
    one); the port's gradients equal its step without remat."""
    x, y = _batch()
    jmodel = JCUNet(out_channels=3, model_depth=50)
    params = _jax_params(jmodel, np.random.default_rng(3), x.numpy())
    jst = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                   tx=jstate.make_optimizer("adamw", reg_weight=1e-5))
    with flags.override(**JAX_PLAIN):
        jst, jm = jax.jit(jsteps.make_train_step("cunet", remat=True))(
            jst, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 1e-3)
    model = CUNet(out_channels=3, model_depth=50)
    load_numpy_state_dict(model, cunet_state_dict_from_jax({"params": params}))
    twin = copy.deepcopy(model)
    seen = []
    model.register_forward_pre_hook(
        lambda m, a: seen.append(recompute_ops.recomputing()))
    step = steps.make_train_step("cunet", model,
                                 state.make_optimizer(model.parameters(), "adamw",
                                                      reg_weight=1e-5), remat=True)
    m = step(x, y, 1e-3)
    assert seen == [False, True]  # the forward, and once again in the backward
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-6)
    want = cunet_state_dict_from_jax(jax.device_get({"params": jst.params}))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=2.5e-3, rtol=1e-4, err_msg=k)
    _, grads0, _ = _step(twin, "cunet", x, y, False)
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, grads0[k]), k


def test_switch_off_restores_the_plain_forward(monkeypatch):
    """``set_remat_blocks(False)``: no region is checkpointed and the step is
    the one without remat; on, every wrapped site is; without a gradient
    (inference) none is, whatever the switch."""
    calls = []
    real = recompute_ops.checkpoint
    monkeypatch.setattr(recompute_ops, "checkpoint",
                        lambda *a, **kw: calls.append(a[0]) or real(*a, **kw))
    x, y = _batch()
    model = _model("cunet")
    assert layers._REMAT_BLOCKS  # the default
    layers.set_remat_blocks(False)
    with layers.remat_blocks(True):
        assert layers._REMAT_BLOCKS
    assert not layers._REMAT_BLOCKS  # the context restores what it found
    steps.make_train_step("cunet", model, state.make_optimizer(model.parameters()))(x, y, 0.0)
    assert calls == []
    layers.set_remat_blocks(True)
    with torch.no_grad():
        model(x)
    with torch.inference_mode():
        model(x)
    assert calls == []
    model(x)
    assert len(calls) == len(_wrapped_sites(model))


def test_eval_entries_switch_remat_off(monkeypatch):
    """The eval CLI's entries run with block remat off and restore the
    switch after (the JAX ``cli/test_main.py:29``)."""
    from hybrid_ctunet_tpu_torch.cli import test_main

    seen = []
    out = test_main._without_remat(lambda args: seen.append(layers._REMAT_BLOCKS) or args, 7)
    assert out == 7 and seen == [False] and layers._REMAT_BLOCKS


def test_dp_step_with_whole_forward_remat(tmp_path):
    """``make_dp_train_step(remat=True)``: the whole forward rematerialized
    inside DDP (``find_unused_parameters``), block remat on, in a gloo
    group of one process: its gradients equal the plain step's."""
    import torch.distributed as dist

    from hybrid_ctunet_tpu_torch.parallel import make_dp_train_step

    x, y = _batch()
    base = _model("cunet")
    model = copy.deepcopy(base)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        seen = []
        model.register_forward_pre_hook(lambda m, a: seen.append(recompute_ops.recomputing()))
        make_dp_train_step("cunet", model, state.make_optimizer(model.parameters(), "adamw"),
                           remat=True)(x, y, 0.0)
    finally:
        dist.destroy_process_group()
    assert seen == [False, True]
    _, grads0, _ = _step(base, "cunet", x, y, False)
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, grads0[k]), k
