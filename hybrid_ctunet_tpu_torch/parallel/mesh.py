"""Process-group bootstrap, the rank-0 gate and the reference's launch.
Port of ``hybrid_ctunet_tpu/parallel/mesh.py:17-69``.

The reference runs one process per GPU (SURVEY.md §2.4,
main_C_TUNet.py:104-121): ``mp.spawn`` over the node's GPUs, ``world_size``
= nodes x GPUs per node, ``rank`` = node rank x GPUs per node + local GPU,
``dist.init_process_group`` over a ``tcp://`` rendezvous. :func:`launch`
does the same, with NCCL on the card and gloo under ``--device cpu`` (one
process a node there). The JAX package drives every local chip from one
process instead.
"""
from __future__ import annotations

import datetime
from typing import Callable, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 1800  # rendezvous and every collective; rank 0 writes checkpoints meanwhile


def initialize_distributed(dist_url: str, world_size: int, rank: int, backend: str = "nccl",
                           timeout_s: float = TIMEOUT_S) -> None:
    """``init_process_group`` at ``dist_url`` (``tcp://host:port`` or
    ``file://path``), with a timeout."""
    dist.init_process_group(backend, init_method=dist_url, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank-0 gate for prints, logs and checkpoint writes (reference
    ``args.rank == 0``, trainer_CTUNet.py:378-405)."""
    return rank_and_world()[0] == 0


def _rank_main(local_rank: int, fn: Callable, args, per_node: int, results) -> None:
    on_card = torch.device(args.device).type == "cuda"
    args.rank = args.rank * per_node + local_rank
    if on_card:
        torch.cuda.set_device(local_rank)
        args.device = f"cuda:{local_rank}"
    initialize_distributed(args.dist_url, args.world_size, args.rank,
                           args.dist_backend if on_card else "gloo")
    try:
        out = fn(args)
        if args.rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args):
    """Run ``fn(args)`` in one process per local device (``--device cuda``:
    every visible GPU; ``--device cpu``: one), ranked as the reference
    ranks them; returns rank 0's result where this node holds rank 0.
    ``args`` needs device, world_size (nodes), rank (node rank), dist_url
    and dist_backend; ``fn`` must be importable (the processes are
    spawned)."""
    import torch.multiprocessing as mp

    per_node = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    if per_node < 1:
        raise SystemExit("no CUDA device is available: pass --device cpu to run on the CPU")
    args.world_size = per_node * args.world_size
    results = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_rank_main, args=(fn, args, per_node, results), nprocs=per_node)
    return results.get() if not results.empty() else None
