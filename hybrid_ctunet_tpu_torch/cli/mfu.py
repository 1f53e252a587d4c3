"""Useful FLOPs and MFU of the bench's models on one CUDA device: the port
of ``tools/mfu_accounting.py``.

    python -m hybrid_ctunet_tpu_torch.cli.mfu [tunet|ctunet|both] [--sw N] [--no-measure]

For each model (full width, random weights from seed 0, bf16; CTUNet's full
forward, every head, as the JAX tool counts it) prints the useful GFLOP of
one chunk of ``--sw`` windows of 96^3 per top-level component
(``utils/flops.py``: 2 x the multiply-adds of the plain reference math),
the TFLOP a chunk and GFLOP a window; then the chunk's time on the card
(chunks back to back through the production path, every kernel on it,
CUDA events, best of 3) and the MFU: useful FLOP/s over the H100's dense
bf16 peak, 989 TFLOP/s, with the card's name and power limit.
``--no-measure`` counts only (meta device, no card); otherwise it needs a
CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from ..utils import flops
from . import bench


def _build(which: str, device):
    build = bench.build_tunet if which == "tunet" else bench.build_ctunet
    return build(0, device)


def measure_chunk_ms(model, sw: int, iters: int = 10) -> float:
    """Milliseconds of one chunk of ``sw`` windows through ``model``:
    ``iters`` chunks back to back between two CUDA events, best of 3."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(1)
    x = torch.randn((sw, *bench.ROI, 1), generator=gen, device=gen.device).to(model.dtype)
    best = float("inf")
    with torch.inference_mode():
        model(x)
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                model(x)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / iters)
    return best


def report(which: str, sw: int, measure: bool = True, model=None) -> Dict:
    """Print and return one model's count and, with ``measure``, its chunk
    time and MFU, measured on ``model`` (the bench's, built on the first
    card, by default)."""
    counts = flops.count_model_flops(_build(which, "meta"), sw, roi=bench.ROI)
    total = sum(counts.values())
    comps = flops.by_component(counts)
    print(f"\n=== {which.upper()}: useful FLOPs (plain reference math), chunk = {sw} windows "
          f"of {'x'.join(map(str, bench.ROI))} ===")
    for name, f in sorted(comps.items(), key=lambda kv: -kv[1]):
        print(f"  {f / 1e9:10.1f} GF  {100 * f / total:5.1f}%  {name}")
    print(f"  total {total / 1e12:.3f} TF/chunk = {total / sw / 1e9:.1f} GF/window")
    out = {"model": which, "sw": sw, "flop_per_chunk": total, "components": comps,
           "chunk_ms": None, "mfu": None}
    if measure:
        if model is None:
            model = _build(which, torch.device("cuda", 0))
        chunk_ms = measure_chunk_ms(model, sw)
        rate = total / (chunk_ms / 1e3)
        out.update(chunk_ms=chunk_ms, mfu=rate / flops.H100_BF16_FLOP_PER_S)
        print(f"  measured chunk {chunk_ms:.3f} ms (every kernel)  ->  {rate / 1e12:.1f} TF/s "
              f"useful  =  MFU {100 * out['mfu']:.1f}% of the H100 bf16 peak "
              f"({flops.H100_BF16_FLOP_PER_S / 1e12:.0f} TF/s); {bench.device_line()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both", choices=("tunet", "ctunet", "both"))
    ap.add_argument("--sw", type=int, default=bench.SW_BATCH, help="windows a chunk")
    ap.add_argument("--no-measure", dest="measure", action="store_false",
                    help="count only (meta device, no card)")
    args = ap.parse_args(argv)
    if args.measure:
        if not torch.cuda.is_available():
            print("error: measuring needs a CUDA device (--no-measure counts only)",
                  file=sys.stderr)
            return 1
        bench.set_precision_flags()
    targets = ["tunet", "ctunet"] if args.which == "both" else [args.which]
    for t in targets:
        report(t, args.sw, args.measure)
    return 0


if __name__ == "__main__":
    sys.exit(main())
