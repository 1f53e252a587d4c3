"""Design variants of K7 (``csrc/pixelweight.cu``), K5
(``csrc/pixel_shuffle.cu``) and K1 (``csrc/scatter.cu``), timed in one
process on the card at the main path's shapes.

    python -m hybrid_ctunet_tpu_torch.cli.kernel_variants [--parent DIR]

Each variant is the committed source with one edit: another choice of a
design constant, or a phase cut (a phase removed, to see what it costs).
Variants build with the port's nvcc flags into ``build/kernel_variants/``
and run through the committed kernel's C entry arguments on the same inputs.
Alternatives are held to the plain version with chip_smoke.py's bf16
tolerance (K1's bit for bit); cuts compute something else and are only
timed. ``--parent DIR`` also builds the kernels of another checkout that
differ from the committed ones, with the C signatures they had before their
Hopper redesign (the design these replaced), and times them beside; K1's
parent also with its index math replaced (``K1_PARENT_VARIANTS``). One
JSON line per (kernel, variant, site): ms per call, the median of 5
CUDA-event timings of 10 back-to-back calls; the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops import pixelweight, scatter, shuffle
from .bench import device_line

OUT_DIR = kernels.BUILD_DIR.parent / "kernel_variants"

# (name, [(old, new)] or a callable on the source, is_cut)
K7_VARIANTS = (
    ("committed", [], False),
    ("stream 2 in one n96 chain at C >= 256", [("bool TWO_PASS = NO >= 256;",
                                                "bool TWO_PASS = false;")], False),
    ("C 256 split over the consumers (64-row tiles)", [("bool SPLIT = C == 512;",
                                                        "bool SPLIT = C >= 256;")], False),
    ("__expf in the softmax", [("expf(dd1 - mx), e2 = expf(dd2 - mx)",
                                "__expf(dd1 - mx), e2 = __expf(dd2 - mx)")], False),
    ("cut: no LayerNorm", lambda s: re.sub(r"ln_rows<C>\([^;]*\);", "", s), True),
    ("cut: no cross-dots and softmax", [("head_weights(acc, pk, w1, w2);",
                                         "w1[0] = w1[1] = w2[0] = w2[1] = "
                                         "__float2bfloat162_rn(0.5f);")], True),
    ("cut: no output projection", [
        ("wgmma_64x128_rs_first(o + 64 * lb, a + 4 * kk, db);",
         "o[64 * lb] = __uint_as_float(a[4 * kk]);"),
        ("wgmma_64x128_rs(o + 64 * lb, a + 4 * kk, db);",
         "o[64 * lb] += __uint_as_float(a[4 * kk]);")], True),
    ("cut: no output store", [("*reinterpret_cast<uint4*>(out + (size_t)(row0 + row)",
                               "if (row < 0) *reinterpret_cast<uint4*>(out + "
                               "(size_t)(row0 + row)")], True),
)
K5_VARIANTS = (
    ("committed", [], False),
    ("2 CTAs an SM at C 256", [("C <= 256 ? 3 : 2", "C <= 256 ? 2 : 2")], False),
    ("4 CTAs an SM at C 256", [("C <= 256 ? 3 : 2", "C <= 256 ? 4 : 2")], False),
    ("ring 6 stages at C 128", [("NL <= 4 ? 4 :", "NL <= 4 ? 6 :")], False),
    ("ring 2 stages at C 512", [("NL <= 8 ? 3 : 0", "NL <= 8 ? 3 : NL <= 16 ? 2 : 0")], False),
    ("no ring (direct loads)", [("NL <= 4 ? 4 : NL <= 8 ? 3 : 0", "0")], False),
    ("128 features a pass", [("constexpr int NT = 8;", "constexpr int NT = 16;")], False),
)

K1_VARIANTS = (
    ("committed", [], False),
    ("runtime C (32-bit division by a variable)", [("if (g.C + 1 == 15) return launch<T, 15>",
                                                    "if (false) return launch<T, 15>")], False),
    ("element copies instead of bulk copies", [("g.bulk = (rz * C * esize) % 16 == 0",
                                                "g.bulk = false && (rz * C * esize) % 16 == 0")],
     False),
    ("1 float4 load in flight a thread", [("constexpr int UNROLL = 2;",
                                           "constexpr int UNROLL = 1;")], False),
    ("4 float4 loads in flight a thread", [("constexpr int UNROLL = 2;",
                                            "constexpr int UNROLL = 4;")], False),
    # each canvas value is stored back unchanged; nvcc may drop such a load
    # and store, and the cut then times the rows' staging alone
    ("cut: no window sums (only the rows' staging)", [("for (int j = 0; j < nw; ++j) {",
                                                       "for (int j = 0; j < 0; ++j) {")],
     True),
)
# edits of the parent's K1 (one thread per canvas element, its index
# divided out in 64 bits): the same division in 32 bits, then by a constant
_INDEX_32 = [("    const int c = (int)(t % K);\n    long long v = t / K;",
              "    const int t32 = (int)t;\n    const int c = t32 % K;\n    int v = t32 / K;"),
             ("const long long local = ((long long)wx * ry + wy) * rz + wz;",
              "const int local = (wx * ry + wy) * rz + wz;")]
K1_PARENT_VARIANTS = (
    ("parent, 32-bit index math", _INDEX_32, False),
    ("parent, 32-bit index math, K = 15 constant",
     _INDEX_32 + [("const int K = C + 1;", "const int K = 15;")], False),
)

K7_SITES = ((4, 12, 12, 24, 512), (4, 24, 24, 48, 256), (4, 48, 48, 96, 128))
K5_SITES = (((4, 6, 6, 12, 768), (2, 2, 2), 512), ((4, 12, 12, 24, 512), (2, 2, 2), 256),
            ((4, 24, 24, 48, 256), (2, 2, 2), 128), ((4, 48, 48, 96, 128), (2, 2, 1), 64))


def _edit(src: str, edit) -> str:
    if callable(edit):
        return edit(src)
    for old, new in edit:
        if old not in src:
            raise ValueError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def _build(path: Path, src: str) -> ctypes.CDLL:
    path.write_text(src)
    so = path.with_suffix(".so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(so),
           str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def _time(fn, reps: int = 5, calls: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _agrees(got, want) -> bool:
    d = (got.float() - want.float()).abs()
    return bool(torch.isfinite(got.float()).all()) and \
        d.max().item() <= 2.0 ** -5 * want.float().abs().max().item() and \
        (d.norm() / want.float().norm()).item() <= 1e-2


def _libs(name: str, variants, parent: Path | None, parent_variants=()):
    """{variant: CDLL}, built in parallel; the parent's source, where it
    differs from the committed one, as 'parent', and ``parent_variants``,
    edits of it."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / f"{name}.cu").read_text()
    jobs = {v: (OUT_DIR / f"{name}_{i}.cu", _edit(src, e))
            for i, (v, e, _) in enumerate(variants)}
    parent_src = parent and (parent / "hybrid_ctunet_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    if parent_src and parent_src != src:  # an unchanged kernel has no other design to time
        jobs["parent"] = (OUT_DIR / f"{name}_parent.cu", parent_src)
        for i, (v, e, _) in enumerate(parent_variants):
            jobs[v] = (OUT_DIR / f"{name}_parent_{i}.cu", _edit(parent_src, e))
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {v: ex.submit(_build, *job) for v, job in jobs.items()}
        return {v: f.result() for v, f in futs.items()}


def run_k7(parent: Path | None, device):
    libs = _libs("pixelweight", K7_VARIANTS, parent)
    cuts = {v for v, _, cut in K7_VARIANTS if cut}
    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std

    for shape in K7_SITES:
        C = shape[-1]
        x1, x2 = randn(*shape).to(bf), randn(*shape).to(bf)
        p = (1 + randn(C, std=0.1), randn(C, std=0.1), 1 + randn(C, std=0.1), randn(C, std=0.1),
             randn(3 * C, C, std=C ** -0.5), randn(3 * C, C, std=C ** -0.5),
             randn(C, C, std=C ** -0.5))
        want = pixelweight.reference_pixelweight(x1, x2, p, bf)
        fn, args, out, keep = pixelweight.pixelweight_call(x1, x2, p, bf)
        for v, lib in libs.items():
            if v == "parent":  # the entry before the redesign: bf16 weights, no scratch
                f = lib.pixelweight
                f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + \
                    [ctypes.c_void_p] * 8
                w = [t.contiguous() for t in p[:4]] + [t.to(bf).contiguous() for t in p[4:]]
                call_args = (*args[:5], *[t.data_ptr() for t in w], args[-1])
            else:
                f = getattr(lib, "pixelweight")
                f.argtypes = fn.argtypes
                call_args = args
            out.zero_()
            kernels.check(f(*call_args), f"pixelweight {v}")
            ok = None if v in cuts else _agrees(out, want)
            yield {"kernel": "pixelweight", "variant": v, "x": list(shape),
                   "ms": _time(lambda: f(*call_args)), "agrees_with_plain": ok}
        del keep


def run_k5(parent: Path | None, device):
    libs = _libs("pixel_shuffle", K5_VARIANTS, parent)
    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    for shape, factor, Fo in K5_SITES:
        cp = shape[-1] // (factor[0] * factor[1] * factor[2])
        x = torch.randn(shape, generator=gen, device=device).to(bf)
        w = torch.randn(Fo, cp, generator=gen, device=device) * cp ** -0.5
        b = torch.randn(Fo, generator=gen, device=device) * 0.1
        want = shuffle.reference_shuffle(x, w, b, factor, bf)
        fn, args, out, keep = shuffle.shuffle_call(x, w, b, factor, bf)
        for v, lib in libs.items():
            f = lib.pixel_shuffle_linear
            if v == "parent":  # the entry before the redesign: bf16 w and b, no type flag
                f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                wb, bb = w.to(bf).contiguous(), b.to(bf).contiguous()
                call_args = (args[0], wb.data_ptr(), bb.data_ptr(), *args[4:])
            else:
                f.argtypes = fn.argtypes
                call_args = args
            out.zero_()
            if f(*call_args):  # the variant does not take this site
                continue
            yield {"kernel": "pixel_shuffle_linear", "variant": v, "x": list(shape),
                   "ms": _time(lambda: f(*call_args)), "agrees_with_plain": _agrees(out, want)}
        del keep


def k1_chunks(device):
    """(name, acc, pred, imp, starts) of K1's four main-path chunk shapes on
    the 256x256x128x15 canvas: windows 4-7 of the TUNet (overlap 0.7) and of
    the CTUNet (0.5) engines, and each engine's trailing chunk (3 of the
    TUNet's 147 windows, 2 of the CTUNet's 50); random canvas, bf16
    predictions as the models emit them."""
    from ..infer.sliding_window import SlidingWindowEngine
    from ..ops.importance import gaussian_importance_map
    from . import bench

    gen = torch.Generator(device=device).manual_seed(0)
    imp = torch.tensor(gaussian_importance_map(bench.ROI), device=device)
    acc = torch.randn(*bench.VOLUME_SHAPE, bench.OUT_CHANNELS + 1, generator=gen, device=device)
    pred = torch.randn(4, *bench.ROI, bench.OUT_CHANNELS, generator=gen,
                       device=device).to(torch.bfloat16)
    chunks = []
    for model, overlap in (("tunet", bench.OVERLAP), ("ctunet", bench.CT_OVERLAP)):
        starts = SlidingWindowEngine(None, bench.ROI, overlap=overlap).plan(bench.VOLUME_SHAPE)[3]
        last = (len(starts) - 1) // 4 * 4
        for name, s in ((f"{model} windows 4-7", starts[4:8]),
                        (f"{model} trailing ({len(starts) - last} of {len(starts)})",
                         starts[last:])):
            chunks.append((name, acc, pred[:len(s)].contiguous(), imp, s))
    return chunks


def run_k1(parent: Path | None, device):
    libs = _libs("scatter", K1_VARIANTS, parent, K1_PARENT_VARIANTS if parent else ())
    cuts = {v for v, _, cut in K1_VARIANTS if cut}
    for name, acc0, pred, imp, starts in k1_chunks(device):
        want = scatter.reference_scatter_add_windows(acc0.clone(), pred, imp, starts)
        group = np.ascontiguousarray(starts, np.int32)
        X, Y, Z, K = acc0.shape
        for v, lib in libs.items():
            f = lib.scatter_add_windows  # one C signature across the designs
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            acc = acc0.clone()
            call_args = (acc.data_ptr(), pred.data_ptr(), 1, imp.data_ptr(), group.ctypes.data,
                         len(group), X, Y, Z, K - 1, *imp.shape, kernels.stream_ptr(device))
            kernels.check(f(*call_args), f"scatter {v}")
            torch.cuda.synchronize()
            ok = None if v in cuts else bool(torch.equal(acc, want))
            yield {"kernel": "scatter_add_windows", "variant": v, "chunk": name,
                   "starts": starts.tolist(), "ms": _time(lambda: f(*call_args)),
                   "bit_exact": ok}
            del acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose K7, K5 and K1 (their C signatures before the redesign) "
                         "are timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: kernel_variants needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(json.dumps({"device": device_line()}), flush=True)
    for row in itertools.chain(run_k7(args.parent, device), run_k5(args.parent, device),
                               run_k1(args.parent, device)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
