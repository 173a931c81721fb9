"""Nothing under `portbench/` imports JAX, jaxlib, flax or the JAX package,
judged on whole top-level module names (`cvpr23_lfdm_torch` is the port,
`cvpr23_lfdm_tpu` the JAX package): by the sources' import statements, and
by `sys.modules` of a process that runs every cell at the tiny sizes."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench.harness import core

PORTBENCH = core.HERE


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    found = {}
    for root, _, files in os.walk(PORTBENCH):
        for f in files:
            if f.endswith(".py"):
                bad = _imports(os.path.join(root, f)) & set(core.FORBIDDEN)
                if bad:
                    found[os.path.relpath(os.path.join(root, f), PORTBENCH)] = bad
    assert not found


def test_whole_names_are_compared(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "cvpr23_lfdm_tpux", types.ModuleType("cvpr23_lfdm_tpux"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert not {"cvpr23_lfdm_tpux", "jaxfoo"} & set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax.linen" in core.forbidden_modules()


RUN_ALL = """
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench.harness import core
from portbench.tests.tiny import OVERRIDES
for w in sorted(OVERRIDES):
    core.run(w, 11, 0.2, True, time.perf_counter(), device="cpu", overrides=OVERRIDES[w])
print("FORBIDDEN", core.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_ALL.format(root=core.ROOT)], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
