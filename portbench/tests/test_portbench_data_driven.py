"""A cell, a traffic mix and a per-layer metric added as files and entries
only: the harness finds them by name and runs them, with no file of the
harness edited."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import core

METRIC = '''"""A dummy reader: the units of the window."""


def read(run):
    return float(run.units)
'''

RUN = """
import json, sys, time
sys.path.insert(0, {tmp!r})
sys.path.insert(1, {repo!r})
import torch
torch.set_num_threads(2)
from portbench.harness import core
assert core.__file__.startswith({tmp!r}), core.__file__
from portbench.tests.tiny import OVERRIDES
o = dict(OVERRIDES["mug-serve-b32"])
o.pop("traffic")
print(json.dumps(core.run("mug-serve-dummy", 5, 0.5, True, time.perf_counter(), device="cpu", overrides=o)))
"""


def test_new_cell_and_metric_from_files(tmp_path):
    tmp = str(tmp_path)
    shutil.copytree(core.HERE, os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    bench["workloads"].append({"name": "mug-serve-dummy", "config": "mug", "traffic": "serve_dummy",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls.dummy", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "frames_per_s",
                               "workloads": ["mug-serve-dummy"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    traffic = {"kind": "serve", "batch": 3, "frame_pool": 5, "warmup_calls": 1, "checked_calls": 1,
               "trace_units": 1}
    with open(os.path.join(tmp, "portbench", "traffic", "serve_dummy.json"), "w") as f:
        json.dump(traffic, f)
    limits = core.load_json(os.path.join(core.HERE, "limits", "mug-serve-b32.json"))
    with open(os.path.join(tmp, "portbench", "limits", "mug-serve-dummy.json"), "w") as f:
        json.dump(limits, f)
    with open(os.path.join(tmp, "portbench", "metrics", "calls.dummy.py"), "w") as f:
        f.write(METRIC)
    out = subprocess.run([sys.executable, "-c", RUN.format(tmp=tmp, repo=core.ROOT)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["attempted"] == 3 * res["window"]["units"]
    assert res["metrics"]["calls.dummy"]["value"] == res["window"]["units"]
    assert set(res["compared"]) == set(limits["numbers"]) | {"failed"}


def test_unread_traffic_key_is_refused(monkeypatch):
    """A mix that names a knob its driver does not read (here `clients`)
    is refused, not measured as the old traffic under a new label."""
    from portbench.drivers import serve
    from portbench.tests.tiny import OVERRIDES

    cell = core.Cell.load("mug-serve-b32")
    monkeypatch.setitem(cell.traffic, "clients", 4)
    ctx = core.Ctx(cell=cell, seed=1, device=torch.device("cpu"), overrides=OVERRIDES["mug-serve-b32"])
    with pytest.raises(ValueError, match="clients"):
        serve.Driver(ctx)
