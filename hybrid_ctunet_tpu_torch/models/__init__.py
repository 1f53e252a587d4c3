from .ctunet import CTUNet
from .cunet import CUNet
from .resnet3d import ResNet3D
from .swin_unetr import SwinUNETR
from .tunet import TUNet, TUNetCore

__all__ = ["CTUNet", "CUNet", "ResNet3D", "SwinUNETR", "TUNet", "TUNetCore"]
