from .tunet import TUNet, TUNetCore

__all__ = ["TUNet", "TUNetCore"]
