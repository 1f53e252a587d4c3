"""The data-parallel train step and metric gathering. Port of
``hybrid_ctunet_tpu/parallel/dp.py:27-120``.

The reference wraps its model in ``DistributedDataParallel(...,
find_unused_parameters=True)`` (main_C_TUNet.py:196-198); so does
:func:`make_dp_train_step`. Every replica's gradient, padded duplicate
samples included, is averaged (DDP semantics; the JAX step means to keep
them but applies the sum of its shards' gradients, ROADMAP C9); the logged
loss is weighted by each rank's validity (the reference's
``distributed_all_gather`` with ``is_valid``, utils/utils.py:42-69).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..train.steps import Rematerialized, TrainStep
from .mesh import rank_and_world


class DPTrainStep(TrainStep):
    """``step(image, label, lr, valid=None) -> {"loss": ..., **aux}`` over
    the default process group: ``image``/``label`` are this rank's shard,
    ``valid`` its per-sample {0, 1} mask (all ones by default). ``model`` is
    the DDP-wrapped one; each rank draws its own dropout masks."""

    def __call__(self, image: torch.Tensor, label: torch.Tensor, lr: float,
                 valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        metrics = super().__call__(image, label, lr)
        if valid is None:
            valid = torch.ones(image.shape[0], device=image.device)
        shard_valid = torch.clamp(valid.float().sum(), max=1.0)  # this rank has real data?
        pair = torch.stack([metrics.pop("loss") * shard_valid, shard_valid])
        dist.all_reduce(pair)
        aux = {}
        if metrics:  # the aux terms (CTUNet's loss1, loss2), averaged over the ranks
            flat = torch.stack([v.float() for v in metrics.values()])
            dist.all_reduce(flat)
            aux = dict(zip(metrics, (flat / rank_and_world()[1]).unbind(0)))
        return {"loss": pair[0] / torch.clamp(pair[1], min=1.0), **aux}


def make_dp_train_step(model_name: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, *, smooth_nr: float = 0.0,
                       smooth_dr: float = 1e-6, grad_accum: int = 1,
                       start_step: int = 0, remat: bool = False) -> DPTrainStep:
    """The data-parallel :class:`DPTrainStep` of ``model_name``. The model is
    wrapped in DDP here (in :class:`Rematerialized` first under ``remat``);
    ``model`` itself stays unwrapped for validation and checkpoints."""
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(
        Rematerialized(model) if remat else model,
        device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True)
    return DPTrainStep(model_name, ddp, optimizer, smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                       grad_accum=grad_accum, rank=rank_and_world()[0], start_step=start_step)


def all_gather_metrics(values: Union[torch.Tensor, Mapping[str, torch.Tensor]]):
    """Every rank's ``values`` concatenated along the leading axis, rank
    order, on every rank (a tensor, or a dict of tensors)."""
    if isinstance(values, Mapping):
        return {k: all_gather_metrics(v) for k, v in values.items()}
    _, world = rank_and_world()
    t = values.contiguous()
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return torch.cat(out)
