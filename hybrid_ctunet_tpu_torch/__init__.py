"""hybrid_ctunet_tpu_torch — the PyTorch/CUDA port of ``hybrid_ctunet_tpu``.

The JAX package beside it is the reference this port is held against. The
port imports ``torch`` and numpy only, never ``jax`` or ``flax``.

- ``ops``     — activations, norms, SAME-padded conv and transposed conv,
                gaussian importance map, DiceCE loss, label downscaling, and
                the kernel modules (scatter, window attention, FFN, pixel
                shuffle and k==s transposed conv, pixelweight,
                InstanceNorm, Winograd 3^3 conv), each a plain PyTorch
                version plus a wrapper that launches a hand-written Hopper
                kernel on CUDA tensors, differentiable through the plain
                version (the scatter, used only in inference, excepted).
- ``models``  — TUNet, ResNet3D, CUNet and CTUNet as ``nn.Module``s with the
                reference's parameter names, InstanceNorm or BatchNorm in
                the conv paths and dropout at the reference's sites.
- ``infer``   — the sliding-window engine with gaussian blending, its chunks
                sharded over the ranks of a process group where there is
                one.
- ``parallel``— the reference's one-process-per-GPU launch, the DDP train
                step, metric gathering.
- ``data``    — NIfTI I/O, the reference's transform chains, the cached
                dataset and the seeded train loader (numpy).
- ``train``   — LR schedules, optimizers, the losses and train step,
                reference-format checkpoints, the training loop.
- ``eval``    — per-organ Dice and HD95, largest-connected-component
                postprocessing, the dice.txt report.
- ``kernels`` — nvcc build of ``csrc/*.cu`` into ctypes libraries, the
                table of kernels with their launch counts, and the check of
                a trace's kernel records against those counts.
- ``utils``   — weight carry-over from the JAX parameter trees, random init,
                scalar logging; tracing (a call's kernel records held to the
                launch counters), step timing, NaN checks and the program's
                spans (``profiling``); the useful FLOPs of a chunk
                (``flops``).
- ``cli``     — ``bench``: the Hybrid-CTUNet ensemble's constructors (models,
                engines, the softmax-mean ensemble);
                ``train_main``: the reference's training entry point;
                ``test_main``: its evaluation entry points.

The port is measured by the benchmark beside it (``python3 -m
benchmark.run``, ``BENCHMARK.json``) and checked on the card by
``chip_smoke.py``.

Public functions keep the JAX package's channels-last (NDHWC) layout.
"""

__version__ = "0.3.0"
