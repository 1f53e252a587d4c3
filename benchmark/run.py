"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Loads and warms up the cell's program, measures
it for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end metrics,
or with ``--trace 1`` the per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checks``: each number compared, with its limit (also
the last lines of standard error). Needs a CUDA device: without one, or
without the program, it exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
