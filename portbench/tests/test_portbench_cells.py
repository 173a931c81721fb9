"""Each cell run through the harness at the tiny sizes on the CPU (the
harness's look for a card skipped): the result line's keys, `correct` with
the cells' own limits when the program runs in fp32, and `correct` false
under the control and under every fault the cell can have."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate
from portbench.harness import core
from portbench.tests.tiny import OVERRIDES

CELLS = sorted(OVERRIDES)
TRAINING = ["natops-dmtrain-b20"]
SEED = 2 ** 40 + 17  # more than 32 bits, as the driver's
# the program in fp32: its gap from the reference is round-off, so the
# check passes it at any size
FP32 = {"form": {"unet_dtype": "float32", "lfae_dtype": "float32"}}


def run(workload, trace=False, seconds=1.0, **extra):
    overrides = {**OVERRIDES[workload], **extra}
    return core.run(workload, SEED, seconds, trace, time.perf_counter(), device="cpu", overrides=overrides)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    res = run(workload, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    cell = core.Cell.load(workload)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", CELLS)
def test_fp32_program_is_correct(workload):
    res = run(workload, **FP32)
    assert res["correct"], res["compared"]


def _altered(drv):
    """Fault: one video's answer altered where it is produced."""
    call = drv.model.sample_video

    def altered(*args, **kwargs):
        out = call(*args, **kwargs)
        out["out_vid"][0] = 1.0 - out["out_vid"][0]
        out["vid_grid"][0] = -out["vid_grid"][0]
        return out

    drv.model.sample_video = altered


FAULTS = [("mug-serve-b32", _altered)] + [(w, calibrate.FAULTS[f]) for w in TRAINING
                                          for f in ("half_batch", "unchanged")]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault):
    res = run(workload, fault=fault, **FP32)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", ["mug-serve-b32", "natops-dmtrain-b20"])
def test_control_is_not_correct(workload):
    """The control, the fp8 reference in the program's place, fails the
    cell's limits."""
    from portbench.harness.check import training_numbers
    from portbench.reference.precision import fp8_e4m3

    cell = core.Cell.load(workload)
    ctx = core.Ctx(cell=cell, seed=SEED, device=torch.device("cpu"), overrides=OVERRIDES[workload])
    drv = core.import_file(f"{core.HERE}/drivers/{cell.traffic['kind']}.py", "d_" + cell.traffic["kind"]).Driver(ctx)
    if workload == "mug-serve-b32":
        from portbench.drivers import serve

        calls = list(range(drv.traffic["checked_calls"]))
        numbers = serve.numbers(drv.reference(calls, precision=fp8_e4m3), drv.reference(calls))
    else:
        numbers = training_numbers(drv.reference(precision=fp8_e4m3), drv.reference())
    correct, _ = core.judge(numbers, cell.limits, failed=0)
    assert not correct, numbers


def test_no_device_no_result(capsys):
    """Without the cell's card the command prints no result and fails."""
    from portbench import run as entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert entry.main(["--workload", "mug-serve-b32", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
