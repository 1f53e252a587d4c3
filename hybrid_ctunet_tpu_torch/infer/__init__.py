from .sliding_window import SlidingWindowEngine, dense_patch_starts, get_scan_interval

__all__ = ["SlidingWindowEngine", "dense_patch_starts", "get_scan_interval"]
