"""Readings that the limits of a cell's check are set from, at the cell's
own size, many seeds in one process (not part of a benchmark run).

    python3 portbench/calibrate.py --workload <name> --seeds <n> [<n> ...] [--control] [--fault half_batch]

For each seed it prints one JSON line per reading: `program` (the
program's timed path against the fp32 reference), `control` (the
reference itself in the precision below the configuration's, fp8 e4m3
for bf16, in the program's place) and each planted fault. Serving compares `checked_calls` calls
run as the window runs them; training the first checked steps.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def half_batch(drv) -> None:
    """Fault: the trainer's step leaves out the second half of the batch and
    takes its mean over the rest."""
    step = drv.trainer.train_step

    def halved(state, rng, batch, **kw):
        cut = lambda v: v if v is None else v[: v.shape[0] // 2]  # noqa: E731
        return step(state, rng, {k: cut(v) for k, v in batch.items()}, **{k: cut(v) for k, v in kw.items()})

    drv.trainer.train_step = halved


def unchanged(drv) -> None:
    """Fault: the optimizer's step returns the state unchanged."""
    opt = drv.trainer.optimizer
    opt.step = lambda step: opt.lr_at(step)


FAULTS = {"half_batch": half_batch, "unchanged": unchanged}


def free(drv) -> None:
    for name in ("model", "trainer", "kept", "losses"):
        if hasattr(drv, name):
            delattr(drv, name)
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    from portbench.harness import core
    from portbench.harness.check import training_numbers
    from portbench.reference.precision import fp8_e4m3
    from portbench.tests.tiny import OVERRIDES as TINY

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--leaves", action="store_true",
                    help="training: add each reading's per-leaf norms (and a line of the reference's)")
    ap.add_argument("--cpu-tiny", action="store_true", help="rehearse on the CPU at the tests' tiny sizes")
    args = ap.parse_args(argv)

    cell = core.Cell.load(args.workload)
    kind = cell.traffic["kind"]
    driver = core.import_file(os.path.join(core.HERE, "drivers", kind + ".py"), "portbench_driver_" + kind)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        t0 = time.perf_counter()
        device = torch.device("cpu") if args.cpu_tiny else torch.device("cuda", 0)
        tiny = TINY[args.workload] if args.cpu_tiny else {}
        ctx = core.Ctx(cell=cell, seed=seed, device=device, overrides=tiny)
        drv = driver.Driver(ctx)
        if kind == "serve":
            for n in range(drv.traffic["checked_calls"]):
                drv.unit(n)
            prog = drv.outputs()
            peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
            free(drv)
            ref = drv.reference(sorted(prog))
            emit({"seed": seed, "reading": "program", **driver.numbers(prog, ref), "peak": peak,
                  "s": time.perf_counter() - t0})
            if args.control:
                t1 = time.perf_counter()
                emit({"seed": seed, "reading": "control", "precision": "fp8_e4m3",
                      **driver.numbers(drv.reference(sorted(prog), precision=fp8_e4m3), ref),
                      "s": time.perf_counter() - t1})
        else:
            prog = drv.readings
            peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
            free(drv)
            t1 = time.perf_counter()
            ref = drv.reference()
            leaves = (lambda r: {"grad": r["grad"], "change": r["change"]} if args.leaves else {})  # noqa: E731
            if args.leaves:
                emit({"seed": seed, "reading": "reference", "loss": ref["loss"], **leaves(ref)})
            emit({"seed": seed, "reading": "program", **training_numbers(prog, ref), "peak": peak,
                  "loss": prog["loss"], "ref_loss": ref["loss"], "s": time.perf_counter() - t0,
                  "reference_s": time.perf_counter() - t1, **leaves(prog)})
            if args.control:
                t1 = time.perf_counter()
                ctl = drv.reference(precision=fp8_e4m3)
                emit({"seed": seed, "reading": "control", "precision": "fp8_e4m3",
                      **training_numbers(ctl, ref), "loss": ctl["loss"], "s": time.perf_counter() - t1, **leaves(ctl)})
            for name in args.fault:
                t1 = time.perf_counter()
                fctx = core.Ctx(cell=cell, seed=seed, device=device, overrides={**tiny, "fault": FAULTS[name]})
                fdrv = driver.Driver(fctx)
                emit({"seed": seed, "reading": name, **training_numbers(fdrv.readings, ref),
                      "loss": fdrv.readings["loss"], "s": time.perf_counter() - t1, **leaves(fdrv.readings)})
                free(fdrv)
        del drv
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
