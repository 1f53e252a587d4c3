"""hybrid_ctunet_tpu_torch — the PyTorch/CUDA port of ``hybrid_ctunet_tpu``.

The JAX package beside it is the reference this port is held against. The
port imports ``torch`` and numpy only, never ``jax`` or ``flax``.

- ``ops``     — activations, norms, SAME-padded conv and transposed conv,
                gaussian importance map, and the kernel modules (scatter,
                window attention, FFN, pixel shuffle and k==s transposed
                conv, pixelweight, InstanceNorm), each a plain PyTorch
                version plus a wrapper that launches a hand-written Hopper
                kernel on CUDA tensors.
- ``models``  — TUNet, ResNet3D, CUNet and CTUNet as ``nn.Module``s with the
                reference's parameter names.
- ``infer``   — the sliding-window engine with gaussian blending.
- ``kernels`` — nvcc build of ``csrc/*.cu`` into ctypes libraries, and the
                table of kernels with their launch counts.
- ``utils``   — weight carry-over from the JAX parameter trees, random init.
- ``cli``     — ``bench``: the Hybrid-CTUNet ensemble on one volume.

Public functions keep the JAX package's channels-last (NDHWC) layout.
"""

__version__ = "0.2.0"
