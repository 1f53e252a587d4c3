"""Data-parallel training and rank-sharded inference over
``torch.distributed``. Port of ``hybrid_ctunet_tpu/parallel``."""
from .dp import all_gather_metrics, make_dp_train_step
from .mesh import initialize_distributed, is_main_process, launch, rank_and_world

__all__ = ["all_gather_metrics", "initialize_distributed", "is_main_process", "launch",
           "make_dp_train_step", "rank_and_world"]
