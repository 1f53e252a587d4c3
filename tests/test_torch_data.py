"""The port's data pipeline, metrics and logging against the JAX package's on
a small synthetic set: NIfTI I/O, the preprocessing chain and its
inversion, the seeded train loader's batches (bit-identical for one seed and
epoch, with the prefetch thread on or off), ``get_loader``, per-organ Dice
and HD95, and the scalar writer."""
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from hybrid_ctunet_tpu.data import dataset as jdataset
from hybrid_ctunet_tpu.data import loader as jloader
from hybrid_ctunet_tpu.data import nifti as jnifti
from hybrid_ctunet_tpu.data import transforms as jtransforms
from hybrid_ctunet_tpu.eval import metrics as jmetrics
from hybrid_ctunet_tpu_torch.data import dataset, loader, nifti, synthetic, transforms
from hybrid_ctunet_tpu_torch.eval import metrics
from hybrid_ctunet_tpu_torch.utils.logging import AverageMeter, ScalarWriter

ROI = (32, 32, 16)
AUG = dict(RandFlipd_prob=0.5, RandRotate90d_prob=0.5, RandScaleIntensityd_prob=0.5,
           RandShiftIntensityd_prob=0.5)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    path = synthetic.write_synthetic_dataset(root, n_train=3, n_val=1, shape=(64, 64, 32))
    return root, path


def _args(root, path):
    return SimpleNamespace(data_dir=root, json_list=os.path.basename(path), batch_size=2,
                           roi_x=ROI[0], roi_y=ROI[1], roi_z=ROI[2], space_x=1.5, space_y=1.5,
                           space_z=2.0, a_min=-175.0, a_max=250.0, b_min=0.0, b_max=1.0,
                           use_normal_dataset=False, distributed=False, test_mode=False, **AUG)


def test_nifti_and_synthetic_match_jax(synth, tmp_path):
    root, path = synth
    spec = json.load(open(path))
    img_path = os.path.join(root, spec["training"][0]["image"])
    got, aff = nifti.load_nifti(img_path)
    want, jaff = jnifti.load_nifti(img_path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(aff, jaff)
    nifti.save_nifti(str(tmp_path / "a.nii"), got, aff)
    jnifti.save_nifti(str(tmp_path / "b.nii"), got, aff)
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()
    # the default writer is the JAX package's, byte for byte
    synthetic.write_synthetic_dataset(str(tmp_path / "p"), n_train=1, n_val=1, shape=(16, 16, 8))
    from hybrid_ctunet_tpu.data.synthetic import write_synthetic_dataset
    write_synthetic_dataset(str(tmp_path / "j"), n_train=1, n_val=1, shape=(16, 16, 8))
    for sub in ("imagesTr/tr_000.nii.gz", "labelsTr/val_000.nii.gz"):
        a = nifti.load_nifti(str(tmp_path / "p" / sub))[0]
        np.testing.assert_array_equal(a, nifti.load_nifti(str(tmp_path / "j" / sub))[0])


def test_preprocess_and_invert_match_jax(synth):
    root, path = synth
    spec = json.load(open(path))
    img, aff = nifti.load_nifti(os.path.join(root, spec["validation"][0]["image"]))
    lab, _ = nifti.load_nifti(os.path.join(root, spec["validation"][0]["label"]))
    got = transforms.preprocess_case(img, aff, lab, resample_labels=False)
    want = jtransforms.preprocess_case(img, aff, lab, resample_labels=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    pred = np.random.default_rng(0).standard_normal((*got[0].shape[:3], 3)).astype(np.float32)
    np.testing.assert_array_equal(transforms.invert_to_native(pred, got[2]),
                                  jtransforms.invert_to_native(pred, want[2]))


@pytest.mark.parametrize("batch_size,prefetch", [(1, 2), (2, 0)])
def test_train_loader_bit_identical_to_jax(synth, batch_size, prefetch):
    """One seed and epoch: every crop and augmentation of every batch equals
    the JAX TrainLoader's."""
    root, path = synth
    from hybrid_ctunet_tpu.data.datalist import load_decathlon_datalist

    files = load_decathlon_datalist(path, data_list_key="training", base_dir=root)
    ours = dataset.TrainLoader(dataset.CachedDataset(files), batch_size=batch_size, roi_size=ROI,
                               seed=7, aug_cfg=AUG, prefetch=prefetch)
    theirs = jdataset.TrainLoader(jdataset.CachedDataset(files), batch_size=batch_size,
                                  roi_size=ROI, seed=7, aug_cfg=AUG, prefetch=prefetch)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    assert len(ours) == len(theirs)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape[1:] == (*ROI, 1) and gi.shape[0] in (4, 4 * batch_size)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_get_loader_matches_jax(synth):
    root, path = synth
    args = _args(root, path)
    tl, vc = loader.get_loader(args)
    jtl, jvc = jloader.get_loader(args)
    assert len(vc) == len(jvc) == 1
    np.testing.assert_array_equal(vc[0].image, jvc[0].image)
    np.testing.assert_array_equal(vc[0].label, jvc[0].label)
    assert vc[0].name == jvc[0].name
    (gi, gl), (wi, wl) = next(iter(tl)), next(iter(jtl))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


def test_prefetch_stops_and_raises(synth):
    """Leaving the loop early ends the producer thread; a producer error
    reaches the consumer."""
    root, path = synth
    from hybrid_ctunet_tpu.data.datalist import load_decathlon_datalist

    ds = dataset.CachedDataset(load_decathlon_datalist(path, base_dir=root))
    before = threading.active_count()
    for _ in dataset.TrainLoader(ds, roi_size=ROI, prefetch=1):
        break
    assert threading.active_count() == before

    class Broken(dataset.TrainLoader):
        def _batches(self):
            yield from ()
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(Broken(ds, roi_size=ROI, prefetch=1))


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 4, (20, 18, 12))
    lab = rng.integers(0, 4, (20, 18, 12))
    lab[lab == 3] = 0  # an organ absent from the label
    np.testing.assert_array_equal(metrics.per_organ_dice(pred, lab, n_classes=4),
                                  jmetrics.per_organ_dice(pred, lab, n_classes=4))
    np.testing.assert_array_equal(metrics.per_organ_hd95(pred, lab, n_classes=4),
                                  jmetrics.per_organ_hd95(pred, lab, n_classes=4))
    assert metrics.dice_score(pred == 1, lab == 1) == jmetrics.dice_score(pred == 1, lab == 1)


def test_scalar_writer_and_meter(tmp_path):
    w = ScalarWriter(str(tmp_path))
    w.add_scalar("train_loss", 1.5, 0)
    w.add_scalar("val_acc_hybrid", 0.25, 1)
    w.close()
    rows = [json.loads(l) for l in open(tmp_path / "scalars.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("train_loss", 1.5, 0), ("val_acc_hybrid", 0.25, 1)]
    ScalarWriter(None).add_scalar("x", 1.0, 0)  # disabled: no file, no error
    m = AverageMeter()
    m.update(2.0, n=3)
    m.update(4.0, n=1)
    assert m.avg == pytest.approx(2.5) and m.count == 4 and m.val == 4.0
