"""In-RAM cached dataset, the rank sampler and the train batch loader. Port
of ``hybrid_ctunet_tpu/data/dataset.py`` (numpy only).

- CacheDataset(cache_num=24, cache_rate=1.0) caching the deterministic
  transform chain (data_utils.py:192-194) -> :class:`CachedDataset`;
- the reference's distributed ``Sampler`` (data_utils.py:22-66) ->
  :class:`ShardSampler`;
- the train DataLoader contract (batch of cases x num_samples crops,
  channels-last arrays) -> :class:`TrainLoader`.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import profiling
from .nifti import load_nifti
from .transforms import augment_crop, preprocess_case, rand_crop_by_pos_neg_label


class CachedDataset:
    """Loads and deterministically preprocesses up to ``cache_num`` cases
    once and keeps them in RAM; the random transforms run on access."""

    def __init__(self, datalist: List[Dict[str, str]], *, cache_num: int = 24,
                 resample_labels: bool = True, pixdim=(1.5, 1.5, 2.0), a_min=-175.0,
                 a_max=250.0, b_min=0.0, b_max=1.0):
        self.datalist = datalist
        self.resample_labels = resample_labels
        self.kw = dict(pixdim=pixdim, a_min=a_min, a_max=a_max, b_min=b_min, b_max=b_max)
        self._cache: Dict[int, tuple] = {}
        for i in range(min(cache_num, len(datalist))):
            self._cache[i] = self._load(i)

    def _load(self, idx: int):
        item = self.datalist[idx]
        img, affine = load_nifti(item["image"])
        label = None
        if "label" in item:
            label, _ = load_nifti(item["label"])
        img_p, lab_p, meta = preprocess_case(
            img, affine, label, resample_labels=self.resample_labels, **self.kw
        )
        return img_p, lab_p, meta, item

    def __len__(self):
        return len(self.datalist)

    def get(self, idx: int):
        if idx in self._cache:
            return self._cache[idx]
        return self._load(idx)


class ShardSampler:
    """Reference Sampler semantics (data_utils.py:22-66): even shards by
    padding, an epoch-seeded permutation, and ``valid_length``, the count of
    this rank's samples that are not padding (a copy of the JAX package's
    ``data/dataset.py:68-100``)."""

    def __init__(self, n: int, num_replicas: int, rank: int, *, shuffle: bool = True,
                 make_even: bool = True):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.make_even = make_even
        self.num_samples = int(math.ceil(n / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.valid_length = len(range(rank, min(self.total_size, n), num_replicas))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> List[int]:
        if self.shuffle:
            g = np.random.default_rng(self.epoch)
            idx = g.permutation(self.n).tolist()
        else:
            idx = list(range(self.n))
        if self.make_even and len(idx) < self.total_size:
            extra = self.total_size - len(idx)
            if extra < len(idx):
                idx += idx[:extra]
            else:
                g = np.random.default_rng(self.epoch + 1)
                idx += [idx[int(i)] for i in g.integers(0, len(idx), extra)]
        return idx[self.rank : self.total_size : self.num_replicas]


class TrainLoader:
    """Yields channels-last train batches (image (B*S, X, Y, Z, 1), label
    (B*S, X, Y, Z, 1)), S = ``num_samples`` crops per case — the reference's
    effective batch (batch_size x RandCropByPosNegLabel num_samples=4,
    data_utils.py:84-93). Every random draw comes from
    ``default_rng((seed, epoch))`` (case order; with a ``sampler``, its
    rank's shard in its order instead) and
    ``default_rng((seed, epoch, case, batch))`` (crops and augmentations), so
    the JAX package's loader yields the same batches."""

    def __init__(self, dataset: CachedDataset, *, batch_size: int = 1,
                 roi_size: Tuple[int, int, int] = (96, 96, 96), num_samples: int = 4,
                 sampler: Optional[ShardSampler] = None, seed: int = 0,
                 aug_cfg: Optional[dict] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.roi_size = roi_size
        self.num_samples = num_samples
        self.sampler = sampler
        self.seed = seed
        self.aug_cfg = aug_cfg or {}
        self.epoch = 0
        self.owner = profiling.new_owner()
        # one producer thread and a bounded queue double-buffer the batches
        # (the reference's DataLoader workers); prefetch=0 is synchronous
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = self.sampler.num_samples if self.sampler else len(self.dataset)
        return math.ceil(n / self.batch_size)

    def _batches(self):
        if self.sampler is not None:
            idx = self.sampler.indices()
        else:
            rng_perm = np.random.default_rng((self.seed, self.epoch))
            idx = [int(i) for i in rng_perm.permutation(len(self.dataset))]
        for b in range(0, len(idx), self.batch_size):
            unit = self.epoch * len(self) + b // self.batch_size
            with profiling.span("loader.batch", unit, self.owner, cuda=False):
                imgs, labs = [], []
                for case_idx in idx[b : b + self.batch_size]:
                    img, lab, _, _ = self.dataset.get(case_idx)
                    rng = np.random.default_rng((self.seed, self.epoch, case_idx, b))
                    crops = rand_crop_by_pos_neg_label(
                        img, lab, rng, spatial_size=self.roi_size, num_samples=self.num_samples
                    )
                    for ci, cl in crops:
                        ci, cl = augment_crop(ci, cl, rng, self.aug_cfg)
                        imgs.append(ci)
                        labs.append(cl)
                batch = np.stack(imgs), np.stack(labs)
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        # the same batch stream as _batches(): every draw is keyed by
        # (seed, epoch, case, batch), so the overlap changes timing only
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
                put(end)
            except Exception as e:  # raised again in the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True, name="TrainLoader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
