"""Data-parallel training and rank-sharded inference (ROADMAP A10) in the
port, run as two gloo ranks on the CPU, against the JAX package's DP step
and window-sharded engine on a 2-device CPU mesh (the oracle pattern of
tests/test_parallel.py and tests/test_norm_batch.py).

The ranks are spawned processes that meet through a ``file://`` rendezvous
in the test's temporary directory (no port to collide on under xdist); they
import only torch and the port, so the JAX package is imported inside the
tests. Each run has a join deadline of ``DEADLINE_S``: a rank still alive
then is killed and the test fails.

The train steps here take one Nesterov SGD step at lr 1 from a zero
momentum (the reference's ``sgd``, momentum 0.99, weight decay 1e-5), whose
change of each parameter, -lr (1 + momentum) (g + wd p), is linear in the
averaged gradient g: a missing update, a flipped sign or a sum in place of
the mean changes it by 50% or more. (A first AdamW step moves every
parameter by about lr whatever its gradient, so it cannot show these.)

Tolerances: ``ShardSampler`` indices equal; one DDP step of the TINY CUNet
(depth 50, 32^3, fp32): the validity-masked logged loss against JAX's DP
step to rtol 1e-4, and each parameter's change against the one that
``jax.value_and_grad`` of the ranks' mean loss gives: its norm to rtol 1e-2
(the gradient tolerance of tests/test_torch_train.py) and its direction to
a relative L2 error of 0.1 (fp32 gradients of this ResNet's first stages
differ from JAX's by 2% elementwise: ROADMAP C5's deep stages normalize
over few values; a flipped sign gives 2). JAX's DP step changes each
parameter world times as far (ROADMAP C9), to the same tolerances.
SyncBatchNorm over two ranks against the one-process global batch: loss
rtol 2e-5, running buffers 3e-5 + 1e-3 relative (tests/test_norm_batch.py:140's
bounds), each parameter's change to the same tolerances but its norm to
rtol 2e-2 (the BatchNorm affines' changes differ by up to 1.0% in norm
between the two summation orders); the op alone, ranks of unequal batch,
in fp32 to 1e-5 (outputs, buffers and the gradients through the
all-reduce); the sharded engine
against the one-process engine and JAX's mesh engine to 1e-6 (the canvases
are summed in another order)."""
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

DEADLINE_S = 120
LR = 1.0
MOMENTUM = 0.99
REG_WEIGHT = 1e-5
SEED = 3


def _rank_main(rank, world, init, fn, args, results):
    from hybrid_ctunet_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(2)
    try:
        initialize_distributed(init, world, rank, "gloo", timeout_s=DEADLINE_S)
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException as e:  # reported to the test, which fails
        import traceback

        results.put((rank, "error", "".join(traceback.format_exception(e))))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(tmp_path, fn, *args, world=2):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their
    results in rank order."""
    import queue
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    out = {}
    try:
        while len(out) < world:
            try:
                rank, status, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                pytest.fail(f"ranks {sorted(set(range(world)) - set(out))} did not finish "
                            f"within {DEADLINE_S} s")
            if status != "ok":
                pytest.fail(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world)]


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)
    return x, y


def _cunet(norm_name="instance"):
    from hybrid_ctunet_tpu_torch.models import CUNet
    from hybrid_ctunet_tpu_torch.utils.params import random_init_

    return random_init_(CUNet(out_channels=3, model_depth=50, norm_name=norm_name), SEED)


def _optimizer(model):
    from hybrid_ctunet_tpu_torch.train.state import make_optimizer

    return make_optimizer(model.parameters(), "sgd", reg_weight=REG_WEIGHT, momentum=MOMENTUM)


def _sgd_change(grad, param):
    """The first Nesterov SGD step's change of a parameter."""
    return -LR * (1.0 + MOMENTUM) * (np.asarray(grad, np.float64) + REG_WEIGHT * param)


def _assert_changes_close(before, got, want_change, norm_rtol=1e-2):
    """Each parameter's change ``got - before`` against ``want_change``
    (dicts of numpy arrays, buffers skipped): norm to ``norm_rtol``,
    relative L2 error at most 0.1."""
    for k, b in before.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        d_got = np.asarray(got[k], np.float64) - b
        d_want = np.asarray(want_change[k], np.float64)
        scale = np.linalg.norm(d_want)
        assert scale > 0, k
        ratio = np.linalg.norm(d_got) / scale
        err = np.linalg.norm(d_got - d_want) / scale
        assert abs(ratio - 1.0) <= norm_rtol and err <= 0.1, \
            f"{k}: change's norm ratio {ratio:.4g}, relative L2 error {err:.3g}"


def _checksum(model):
    return float(sum(p.detach().double().abs().sum() for p in model.parameters()))


def _dp_rank(rank, world, path, norm_name, valid):
    """One DDP step on this rank's sample of the batch; rank 0 saves the
    state dict."""
    from hybrid_ctunet_tpu_torch.parallel import all_gather_metrics, make_dp_train_step

    from hybrid_ctunet_tpu_torch.models.layers import convert_sync_batchnorm

    x, y = _batch()
    model = convert_sync_batchnorm(_cunet(norm_name))
    step = make_dp_train_step("cunet", model, _optimizer(model))
    m = step(torch.from_numpy(x[rank:rank + 1]), torch.from_numpy(y[rank:rank + 1]), LR,
             valid=torch.tensor([valid[rank]]))
    if rank == 0:
        torch.save(model.state_dict(), path)
    gathered = all_gather_metrics({"rank": torch.tensor([float(rank)])})["rank"]
    return {"loss": m["loss"].item(), "checksum": _checksum(model),
            "gathered": gathered.tolist()}


def test_shard_sampler_matches_jax():
    """Indices and valid lengths over (n, replicas, epoch), uneven cases
    (n not a multiple of the replicas, n smaller than them) included."""
    from hybrid_ctunet_tpu.data.dataset import ShardSampler as JShardSampler
    from hybrid_ctunet_tpu_torch.data.dataset import ShardSampler

    for n in (1, 2, 5, 8, 10, 24):
        for replicas in (1, 2, 3, 8):
            for epoch in (0, 1, 7):
                for shuffle in (True, False):
                    for rank in range(replicas):
                        got = ShardSampler(n, replicas, rank, shuffle=shuffle)
                        want = JShardSampler(n, replicas, rank, shuffle=shuffle)
                        got.set_epoch(epoch)
                        want.set_epoch(epoch)
                        assert got.indices() == want.indices(), (n, replicas, epoch, rank)
                        assert (got.num_samples, got.valid_length) == (
                            want.num_samples, want.valid_length)


def test_dp_step_matches_jax(tmp_path):
    """A 2-rank gloo DDP step of the TINY CUNet against the JAX
    ``make_dp_train_step`` on a 2-device CPU mesh, rank 1's sample padding
    (valid 0): the logged loss is rank 0's alone, every rank holds the same
    updated parameters, each changed by the gradient averaged over both
    samples, the padded one included (``jax.value_and_grad`` of the mean
    loss), and JAX's DP step by twice that (ROADMAP C9);
    ``all_gather_metrics`` gathers in rank order."""
    import jax
    import jax.numpy as jnp

    from hybrid_ctunet_tpu import flags
    from hybrid_ctunet_tpu.models import CUNet as JCUNet
    from hybrid_ctunet_tpu.parallel import make_dp_train_step as jmake_dp_train_step
    from hybrid_ctunet_tpu.parallel import make_mesh, replicate_state, shard_batch
    from hybrid_ctunet_tpu.train import state as jstate
    from hybrid_ctunet_tpu.train import steps as jsteps
    from hybrid_ctunet_tpu.utils.torch_import import convert_cunet
    from hybrid_ctunet_tpu_torch.utils.params import cunet_state_dict_from_jax

    path = str(tmp_path / "dp.pt")
    r0, r1 = _run_ranks(tmp_path, _dp_rank, path, "instance", [1.0, 0.0])
    assert r0["loss"] == r1["loss"] and r0["checksum"] == r1["checksum"]
    assert r0["gathered"] == r1["gathered"] == [0.0, 1.0]

    x, y = _batch()
    sd = {k: v.numpy() for k, v in _cunet().state_dict().items()}
    params = convert_cunet(sd, model_depth=50)["params"]
    jmodel = JCUNet(out_channels=3, model_depth=50)
    mesh = make_mesh(devices=jax.devices()[:2])
    jst = replicate_state(jstate.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=jstate.make_optimizer("sgd", reg_weight=REG_WEIGHT, momentum=MOMENTUM)), mesh)
    im, lb, vd = shard_batch((jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray([1.0, 0.0], jnp.float32)), mesh)

    def mean_loss(p):  # DDP's gradient: the mean of the ranks' loss gradients
        return sum(jsteps.cunet_loss_fn(jmodel.apply({"params": p}, jnp.asarray(x[i:i + 1])),
                                        jnp.asarray(y[i:i + 1]))[0] for i in range(2)) / 2

    with flags.override(ZFOLD="0", ALTFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
                        PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0",
                        PALLAS_SHUFFLE="0", TRANSP_PALLAS="0"):
        jst, jm = jmake_dp_train_step("cunet", mesh, donate=False)(jst, im, lb, vd, LR)
        grads = jax.jit(jax.grad(mean_loss))(params)
    np.testing.assert_allclose(r0["loss"], float(jm["loss"]), rtol=1e-4)
    grad = cunet_state_dict_from_jax(jax.device_get({"params": grads}))
    got = {k: v.numpy() for k, v in torch.load(path).items()}
    os.remove(path)  # ~0.2 GB: free the disk for the rest of the suite
    assert set(got) == set(grad) == set(sd)
    _assert_changes_close(sd, got, {k: _sgd_change(g, sd[k]) for k, g in grad.items()})
    # ROADMAP C9: the JAX DP step applies the sum of the shards' gradients
    jax_after = cunet_state_dict_from_jax(jax.device_get({"params": jst.params}))
    _assert_changes_close(sd, jax_after, {k: _sgd_change(2 * g, sd[k]) for k, g in grad.items()})


def test_sync_batchnorm_matches_global_batch(tmp_path):
    """SyncBatchNorm over 2 ranks of one sample each equals BatchNorm over
    the global batch of two in one process: the logged loss, the running
    buffers and each parameter's change in one step (the sums of x and x^2
    and the count are all-reduced, through the backward too)."""
    from hybrid_ctunet_tpu_torch.train.steps import make_train_step

    path = str(tmp_path / "sync.pt")
    r0, r1 = _run_ranks(tmp_path, _dp_rank, path, "batch", [1.0, 1.0])
    assert r0["checksum"] == r1["checksum"]

    x, y = _batch()
    model = _cunet("batch")
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    m = make_train_step("cunet", model, _optimizer(model))(torch.from_numpy(x),
                                                           torch.from_numpy(y), LR)
    np.testing.assert_allclose(r0["loss"], m["loss"].item(), rtol=2e-5)
    got = {k: v.numpy() for k, v in torch.load(path).items()}
    os.remove(path)  # ~0.2 GB: free the disk for the rest of the suite
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], v, atol=3e-5, rtol=1e-3, err_msg=k)
    _assert_changes_close(before, got, {k: want[k] - before[k] for k in before},
                          norm_rtol=2e-2)


def _sync_op_inputs():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 3, 6)) * 2 + 1).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, dy, np.linspace(0.5, 1.5, 6, dtype=np.float32), \
        np.linspace(-0.2, 0.3, 6, dtype=np.float32)


def _sync_op(x, dy, w, b, sync):
    from hybrid_ctunet_tpu_torch.ops.norm import batch_norm

    x, w, b = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    rm, rv = torch.zeros(6), torch.ones(6)
    y = batch_norm(x, w, b, rm, rv, training=True, sync=sync)
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
            "db": b.grad.numpy(), "rm": rm.numpy(), "rv": rv.numpy()}


def _sync_op_rank(rank, world):
    x, dy, w, b = _sync_op_inputs()
    rows = slice(0, 2) if rank == 0 else slice(2, 3)  # unequal: 2 samples and 1
    return _sync_op(x[rows], dy[rows], w, b, sync=True)


def test_sync_batchnorm_op_backward(tmp_path):
    """The op with ``sync`` on 2 ranks of 2 and 1 samples against the op on
    the 3 samples in one process: outputs, the running buffers (Bessel's
    factor over the global count), the input's gradient, and the affine's
    gradients summed over the ranks (as DDP sums them), through the
    autograd all-reduce of the sums of x and x^2 and the count."""
    r0, r1 = _run_ranks(tmp_path, _sync_op_rank)
    want = _sync_op(*_sync_op_inputs(), sync=False)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r0["y"], r1["y"]]), want["y"], **tol)
    np.testing.assert_allclose(np.concatenate([r0["dx"], r1["dx"]]), want["dx"], **tol)
    for k in ("dw", "db"):
        np.testing.assert_allclose(r0[k] + r1[k], want[k], err_msg=k, **tol)
    for r in (r0, r1):
        for k in ("rm", "rv"):
            np.testing.assert_allclose(r[k], want[k], err_msg=k, **tol)


W = np.array([[0.5, -1.25, 2.0]], np.float32)  # (C_in=1, 3)
B = np.array([0.25, -0.5, 1.0], np.float32)
W2 = np.array([[-0.75, 1.5]], np.float32)
# (volume, overlap, sw_batch): 24 windows in 5 chunks (3 on rank 0, 2 on
# rank 1); one window in one chunk (rank 1 runs none)
ENGINE_CASES = [((70, 61, 45), 0.5, 5), ((20, 24, 28), 0.7, 3)]
ROI = (32, 32, 32)


def _torch_pred(x):
    y = torch.matmul(x, torch.from_numpy(W)) + torch.from_numpy(B)
    return y, torch.matmul(x, torch.from_numpy(W2))


def _volume(size):
    return np.random.default_rng(size[0]).standard_normal((1, *size, 1)).astype(np.float32)


def _engine_rank(rank, world):
    from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine

    outs, chunks = [], []
    for size, overlap, sw in ENGINE_CASES:
        engine = SlidingWindowEngine(_torch_pred, ROI, sw_batch_size=sw, overlap=overlap,
                                     num_outputs=2, rank=rank, world=world)
        calls = []
        engine.predictor = lambda x: calls.append(len(x)) or _torch_pred(x)
        with torch.inference_mode():
            outs.append([o.numpy() for o in engine(torch.from_numpy(_volume(size)))])
        chunks.append(calls)
    return {"outs": outs, "chunks": chunks}


def test_sharded_engine_matches_single_and_jax(tmp_path):
    """The 2-rank sharded engine at window counts that do not divide evenly
    (5 chunks; 1 chunk, so that rank 1 runs none) against the one-process
    engine and the JAX engine on a 2-device mesh: chunk c runs on rank
    c mod 2 only, no window twice, and every rank holds the blended maps."""
    import jax
    import jax.numpy as jnp

    from hybrid_ctunet_tpu.infer.sliding_window import SlidingWindowEngine as JEngine
    from hybrid_ctunet_tpu.parallel import make_mesh
    from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine

    r0, r1 = _run_ranks(tmp_path, _engine_rank)
    assert r0["chunks"] == [[5, 5, 4], [1]] and r1["chunks"] == [[5, 5], []]
    mesh = make_mesh(devices=jax.devices()[:2])

    def jpred(x):
        y = jnp.dot(x, jnp.asarray(W)) + jnp.asarray(B)
        return y, jnp.dot(x, jnp.asarray(W2))

    for i, (size, overlap, sw) in enumerate(ENGINE_CASES):
        vol = _volume(size)
        with torch.inference_mode():
            single = SlidingWindowEngine(_torch_pred, ROI, sw_batch_size=sw, overlap=overlap,
                                         num_outputs=2)(torch.from_numpy(vol))
        jmesh = JEngine(jpred, ROI, sw_batch_size=sw, overlap=overlap, num_outputs=2,
                        mesh=mesh)(jnp.asarray(vol))
        for k in range(2):
            assert np.array_equal(r0["outs"][i][k], r1["outs"][i][k])
            for want in (single[k].numpy(), np.asarray(jmesh[k])):
                assert r0["outs"][i][k].shape == want.shape == (1, *size, want.shape[-1])
                np.testing.assert_allclose(r0["outs"][i][k], want, rtol=1e-6, atol=1e-6)


def test_train_and_eval_cli_distributed(tmp_path, monkeypatch):
    """``train_main --distributed --device cpu`` (one gloo rank a node;
    the TINY CUNet with BatchNorm) trains, validates through the sharded
    engine and writes its checkpoints from rank 0; they carry the running
    buffers. ``test_single --distributed`` evaluates the checkpoint."""
    from hybrid_ctunet_tpu_torch.cli import test_main, train_main
    from hybrid_ctunet_tpu_torch.data.synthetic import write_synthetic_dataset

    monkeypatch.chdir(tmp_path)
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    json_list = os.path.basename(write_synthetic_dataset(data, shape=(48, 48, 40),
                                                         n_classes=3))
    common = ["--device", "cpu", "--distributed", "--model_name", "cunet", "--json_list",
              json_list, "--model_depths", "50", "--norm_name", "batch",
              "--roi_x", "32", "--roi_y", "32", "--roi_z", "32", "--out_channels", "3",
              "--noamp", "--infer_overlap", "0", "--data_dir", data]
    best = train_main.main("c_tunet", common + ["--dist-url", f"file://{tmp_path / 'rdv1'}",
                                                "--max_epochs", "1",
                                                "--val_every", "1", "--save_checkpoint",
                                                "--logdir", logs])
    assert np.isfinite(best["acc"]) and "latest.pt" in os.listdir(logs)
    sd = torch.load(os.path.join(logs, "latest.pt"), weights_only=False)["state_dict"]
    assert int(sd["convnet.norm1.num_batches_tracked"]) == 2  # two train batches
    rows = test_main.test_single(common + ["--dist-url", f"file://{tmp_path / 'rdv2'}",
                                           "--pretrained_dir", logs,
                                           "--pretrained_model_name", "latest.pt",
                                           "--exp_name", "dist"])
    assert rows.shape == (1, 2) and np.isfinite(rows).all()
    assert (tmp_path / "outputs" / "dist" / "dice.txt").exists()
    shutil.rmtree(logs)  # ~0.5 GB of checkpoints: free the disk for the rest of the suite
