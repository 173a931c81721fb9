"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cell's CUDA cards.
With `--trace 0` the last line of standard output is the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, beside `correct`,
`attempted`, `failed` and `device`. The numbers compared with the
reference, each beside its limit, are the last lines of standard error and
the last key of the result line. Without the cards, or with JAX loaded in
the process once the window has closed, it prints no result and exits with
a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout; no
# library that the port uses may load JAX (`transformers` does unless told)
CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import core

    try:
        result = core.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except core.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    found = core.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in the process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
