"""Ops of the port (channels-last, NDHWC). Kernel modules: ``scatter``,
``attention``, ``ffn``, ``shuffle``, ``pixelweight``, ``norm``, ``winograd``;
``recompute`` gives their wrappers a backward. Training: ``losses``,
``resize``."""
from .act import gelu_exact, leaky_relu
from .conv import conv3d_same, conv_transpose3d_same, same_padding, transpose_output_padding
from .importance import gaussian_importance_map
from .norm import instance_norm, instance_norm_leaky, layer_norm
