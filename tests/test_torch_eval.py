"""The port's evaluation path against the JAX package's, on the same
numpy-seeded inputs: the dice.txt report (byte-identical), largest-CC
postprocessing and its decision record (equal, advanced mode included), and
``test_final`` end to end at tests/test_cli.py's tiny flags (the port's
random-init checkpoints, read by both packages: per-organ Dice within 1e-3,
masks equal on >= 99.9% of voxels, HD95 equal for every organ whose mask is
equal); the port's ``test_single`` and ``test_ctunet`` runs, the eval
host/device pipeline, and the flags the eval CLI refuses."""
import os
import shutil

import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu import flags
from hybrid_ctunet_tpu.eval import postprocess as jpostprocess
from hybrid_ctunet_tpu.eval import report as jreport
from hybrid_ctunet_tpu_torch.cli import factory
from hybrid_ctunet_tpu_torch.cli import test_main as tm
from hybrid_ctunet_tpu_torch.cli.args import build_test_parser
from hybrid_ctunet_tpu_torch.data.nifti import load_nifti
from hybrid_ctunet_tpu_torch.data.synthetic import write_synthetic_dataset
from hybrid_ctunet_tpu_torch.eval import postprocess, report
from hybrid_ctunet_tpu_torch.train.checkpoint import save_checkpoint
from hybrid_ctunet_tpu_torch.train.state import make_optimizer

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

# the JAX package's plain layouts (tests/test_torch_train.py): its TPU
# rewrites are the same math and take twice as long to compile on the CPU
JAX_PLAIN = dict(ZFOLD="0", ALTFOLD="0", FOLD96="0", STEM_Z4="0", VIRTUAL_CONCAT="0",
                 PALLAS_FFN="0", PALLAS_FFN_PAIR="0", PALLAS_ATTN="0", PALLAS_SHUFFLE="0",
                 TRANSP_PALLAS="0")


@pytest.mark.parametrize("n_classes", [13, 4])
def test_dice_report_matches_jax(tmp_path, n_classes):
    """Byte-identical reports: the reference's organ labels at 13 classes,
    generic ones otherwise; two cases, an extra mean block, appended twice."""
    rng = np.random.default_rng(n_classes)
    rows = rng.uniform(0, 1, (2, n_classes))
    extra = {"res": rng.uniform(0, 1, (2, n_classes))}
    for mod, d in ((report, tmp_path / "port"), (jreport, tmp_path / "jax")):
        for _ in range(2):
            mod.write_dice_report(str(d), ["a.nii.gz", "b.nii.gz"], rows, filename="r.txt",
                                  extra_means=extra)
    assert (tmp_path / "port" / "r.txt").read_bytes() == (tmp_path / "jax" / "r.txt").read_bytes()
    assert report.REPORT_LABELS == jreport.REPORT_LABELS


def _label_volumes(seed, n, shape=(14, 13, 12), classes=4):
    """Blocky label volumes: a coarse random grid upsampled, so each class
    comes in several components of several sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.integers(0, classes, [(s + 2) // 3 for s in shape]).astype(np.uint8)
        v = coarse.repeat(3, 0).repeat(3, 1).repeat(3, 2)[:shape[0], :shape[1], :shape[2]]
        out.append(np.ascontiguousarray(v))
    return out


@pytest.mark.parametrize("classes,vpv,min_size", [
    ([1, 2, 3], 1.0, None),
    ([(1, 2), 3], 2.5, None),
    ([1, 3], 1.0, {1: 40.0, 3: 100.0}),
])
def test_remove_all_but_largest_component_matches_jax(classes, vpv, min_size):
    (img,) = _label_volumes(3, 1)
    got = postprocess.remove_all_but_largest_component(img, classes, vpv, min_size)
    want = jpostprocess.remove_all_but_largest_component(img, classes, vpv, min_size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (got[0] != img).any()  # something was removed


@pytest.mark.parametrize("advanced", [False, True])
def test_determine_postprocessing_matches_jax(capsys, advanced):
    """Equal outputs and an equal decision record (the printed 'for which
    classes' and minimum sizes, with every dice line) on three seeded
    cases whose predictions are the labels plus spurious islands."""
    labels = _label_volumes(5, 3)
    rng = np.random.default_rng(6)
    infers = []
    for lab in labels:
        pred = lab.copy()
        for _ in range(4):
            x, y, z = (rng.integers(0, s - 2) for s in lab.shape)
            pred[x:x + 2, y:y + 2, z:z + 2] = rng.integers(1, 4)
        infers.append(pred)
    vpv = [1.0, 2.0, 1.5]
    outs = []
    for mod in (postprocess, jpostprocess):
        outs.append((mod.determine_postprocessing(infers, labels, vpv, processes=2,
                                                  advanced_postprocessing=advanced,
                                                  classes=[1, 2, 3]),
                     capsys.readouterr().out))
    (got, got_log), (want, want_log) = outs
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_log == want_log and "for which classes:" in got_log


def test_pipeline_cases_keeps_order_and_raises():
    """The depth-1 pipeline gives the serial loop's results in case order,
    and a worker's exception propagates."""
    import time

    cases = list(range(7))

    def finish(c, h):
        time.sleep(0.002 * (c % 3))
        return (c, h)

    assert tm._pipeline_cases(cases, lambda c: c * 10, finish) == [(c, c * 10) for c in cases]

    def bad(c, h):
        if c == 3:
            raise ValueError("boom")
        return (c, h)

    with pytest.raises(ValueError, match="boom"):
        tm._pipeline_cases(cases, lambda c: c * 10, bad)


# tests/test_cli.py:339-345's tiny flags, on the CPU
TINY = ["--roi_x=32", "--roi_y=32", "--roi_z=32", "--out_channels=3", "--model_depths=50",
        "--patch_frame=8", "--hidden_size=64", "--num_depths=1", "--mlp_dim=128",
        "--num_heads=2", "--feature_size=16", "--window=2", "--noamp", "--space_x=1.5",
        "--space_y=1.5", "--space_z=2.0"]


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """A synthetic (48, 48, 40) validation case, and the port's random-init
    checkpoints in the reference's format: three CTUNet files and a TUNet
    ``model_vit.pt`` (the CUNet's as ``model_res.pt`` beside it); removed
    after the module's tests."""
    root = tmp_path_factory.mktemp("eval")
    data = root / "data"
    path = write_synthetic_dataset(str(data), n_train=1, n_val=1, shape=(48, 48, 40))
    flags_ = TINY + [f"--data_dir={data}", f"--json_list={os.path.basename(path)}"]
    args = build_test_parser("ctunet").parse_args(flags_ + ["--device=cpu"])
    for name, sub, files in (("ctunet", "ct", ("model_res.pt", "model_vit.pt", "model_hybrid.pt")),
                             ("tunet", "tu", ("model_vit.pt",)), ("cunet", "tu", ("model_res.pt",))):
        args.model_name = name
        model = factory.build_model(args, torch.device("cpu"))
        for f in files:
            save_checkpoint(str(root / sub), f, model, make_optimizer(model.parameters()),
                            epoch=0, best_acc=0.0)
    yield root, flags_
    shutil.rmtree(root)  # ~1 GB of checkpoints: free the disk for the rest of the suite


def _jax_pt_params(args, model_name, path):
    """The JAX package's ``.pt`` read, ``load_params_from_torch``, with the
    arguments each converter takes. (Its ``load_eval_params`` passes
    ``model_depth`` to every converter, which ``convert_tunet`` refuses, and
    no ViT depth, so that it reads only 12-block checkpoints: ROADMAP C8.)"""
    from hybrid_ctunet_tpu.train.checkpoint import load_params_from_torch

    kw = {} if model_name == "tunet" else {"model_depth": args.model_depths}
    if model_name != "cunet":
        kw["depth"] = args.num_depths
    return load_params_from_torch(path, model_name, **kw)


def test_final_matches_jax(eval_dirs, monkeypatch):
    """The port's ``test_final`` against the JAX package's on the same case
    and ``.pt`` files (the JAX side reads them through
    ``load_params_from_torch``), both in fp32: per-organ Dice within 1e-3,
    the saved masks equal on >= 99.9% of voxels, HD95 equal for every organ
    whose mask is equal in both (all of them if the masks are equal)."""
    from hybrid_ctunet_tpu.cli import test_main as jtm

    root, flags_ = eval_dirs
    dirs = [f"--ctunet_dir={root / 'ct'}", f"--tunet_dir={root / 'tu'}"]
    monkeypatch.chdir(root)
    monkeypatch.setattr(jtm, "load_eval_params", _jax_pt_params)
    got = tm.test_final(flags_ + dirs + ["--device=cpu", "--exp_name=port"])
    with flags.override(**JAX_PLAIN):
        want = jtm.test_final(flags_ + dirs + ["--exp_name=jax"])
    assert got["postprocessed"] is False
    np.testing.assert_allclose(got["dice"], want["dice"], atol=1e-3, rtol=0)
    name = os.listdir(root / "outputs" / "port")
    case = [n for n in name if n.endswith(".nii.gz")][0]
    mask, _ = load_nifti(str(root / "outputs" / "port" / case))
    jmask, _ = load_nifti(str(root / "outputs" / "jax" / case))
    assert mask.shape == jmask.shape == (48, 48, 40)
    assert (mask == jmask).mean() >= 0.999
    for c in range(1, 14):
        if np.array_equal(mask == c, jmask == c):
            assert got["hd95"][c - 1] == want["hd95"][c - 1], c
    report_text = (root / "outputs" / "port" / "dice.txt").read_text()
    assert "mean_hd95:" in report_text and np.isfinite(got["hd95"]).all()


def test_final_postprocess_reports_the_processed_masks(eval_dirs, monkeypatch):
    """--postprocess: the returned Dice is the postprocessed masks' (the
    postprocessor stubbed to return the labels gives 0/1 per organ, 1 where
    the organ is in the label), and the report says so."""
    root, flags_ = eval_dirs
    monkeypatch.chdir(root)
    monkeypatch.setattr(tm, "determine_postprocessing",
                        lambda infers, labels, *a, **k: [l.copy() for l in labels])
    out = tm.test_final(flags_ + [f"--ctunet_dir={root / 'ct'}", f"--tunet_dir={root / 'tu'}",
                                  "--device=cpu", "--exp_name=pp", "--postprocess"])
    assert out["postprocessed"] is True
    d = np.asarray(out["dice"])
    assert np.all((d == 0.0) | (d == 1.0)) and d.mean() > 0.0
    assert "dsc_postprocessed: " in (root / "outputs" / "pp" / "dice.txt").read_text()


@pytest.mark.parametrize("entry", ["single cunet", "single tunet", "ctunet"])
def test_single_and_ctunet_run(eval_dirs, monkeypatch, entry):
    """The port's test_single (CUNet's ``model_res.pt``, TUNet's
    ``model_vit.pt``) and test_ctunet (three checkpoints, two passes):
    finite rows of per-organ Dice, reports and masks written."""
    root, flags_ = eval_dirs
    monkeypatch.chdir(root)
    if entry.startswith("single"):
        name = entry.split()[1]
        file = {"cunet": "model_res.pt", "tunet": "model_vit.pt"}[name]
        rows = tm.test_single(flags_ + ["--device=cpu", f"--model_name={name}",
                                        f"--pretrained_dir={root / 'tu'}",
                                        f"--pretrained_model_name={file}",
                                        f"--exp_name=one_{name}"])
        assert rows.shape == (1, 2) and np.isfinite(rows).all()
        assert (root / "outputs" / f"one_{name}" / "dice.txt").exists()
        return
    results = tm.test_ctunet(flags_ + ["--device=cpu", f"--pretrained_dir={root / 'ct'}",
                                       "--exp_name=ct3"])
    assert set(results) == {"res+vit", "hybrid"}
    for r in results.values():
        assert r.shape == (1, 2) and np.isfinite(r).all()
    files = set(os.listdir(root / "outputs" / "ct3"))
    assert {"dice_res+vit.txt", "dice_hybrid.txt"} <= files
    assert sum(f.endswith(".nii.gz") for f in files) == 2


@pytest.mark.parametrize("extra,match", [
    ([], "--device cpu"),
    (["--device=cpu", "--norm_name=batch"], "running_mean"),
    (["--device=cpu", "--distributed", "--dropout_rate=0.2", "--exp_name=dist"], None),
    (["--device=cpu", "--resume_jit"], "TorchScript"),
])
def test_eval_cli_refuses(eval_dirs, monkeypatch, extra, match):
    """--device defaults to cuda and the entries refuse to run without a
    card; --resume_jit exits. --norm_name batch reaches the model: the
    instance-norm checkpoints lack its BatchNorm parameters and buffers.
    --distributed runs (one gloo rank on the CPU; with --dropout_rate 0.2,
    the identity in eval mode) and rank 0 writes the outputs."""
    if not extra and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root, flags_ = eval_dirs
    monkeypatch.chdir(root)
    assert build_test_parser("ctunet").parse_args([]).device == "cuda"
    argv = flags_ + [f"--ctunet_dir={root / 'ct'}", f"--tunet_dir={root / 'tu'}", *extra]
    if match is None:
        out = tm.test_final(argv)
        assert np.isfinite(out["dice"]).all()
        assert (root / "outputs" / "dist" / "dice.txt").exists()
        return
    with pytest.raises(KeyError if "running" in match else SystemExit, match=match):
        tm.test_final(argv)


def test_eval_accepts_dropout_and_refuses_orbax_dirs(eval_dirs, monkeypatch, tmp_path):
    """--dropout_rate > 0 runs at eval (eval mode: dropout is the identity);
    an orbax checkpoint directory exits with a message; a bad entry name
    prints the usage."""
    root, flags_ = eval_dirs
    monkeypatch.chdir(root)
    factory.check_supported(build_test_parser("ctunet").parse_args(["--dropout_rate=0.2"]))
    orbax = tmp_path / "ct"
    (orbax / "model_res.pt").mkdir(parents=True)
    with pytest.raises(SystemExit, match="orbax"):
        tm.test_final(flags_ + [f"--ctunet_dir={orbax}", f"--tunet_dir={root / 'tu'}",
                                "--device=cpu", "--dropout_rate=0.2"])
    assert tm.main(["bogus"]) == 2
