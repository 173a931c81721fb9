"""The benchmark's own spans and kernel-call records, installed from outside
the program for the traced units only.

`span` wraps an attribute of one of the program's objects (a bound method
of a module, the sampler of the diffusion) in a
`torch.profiler.record_function` range named `portbench::<part>`.
`record_calls` wraps a kernel entry of one of the program's modules so
that every call's `(flops, bytes)` is counted from its arguments' shapes
by a function of `harness/counts.py`. Both are undone by `Installed.undo`.
"""

from __future__ import annotations

import functools

from torch.profiler import record_function

from portbench.harness.trace import PREFIX


class Installed:
    """Wrappers put in place, and how to take them out again."""

    def __init__(self):
        self._undo = []
        self.calls = {}  # kernel -> list of (flops, bytes)

    def span(self, obj, attr: str, part: str):
        original = getattr(obj, attr)

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with record_function(PREFIX + part):
                return original(*args, **kwargs)

        self._set(obj, attr, wrapped, original)

    def record_calls(self, module, name: str, count, key: str | None = None):
        """Count each call of `module.<name>` by `count(*args)`, and each
        backward of it by `count.backward(*args)` where given."""
        original = getattr(module, name)
        store = self.calls.setdefault(key or name, [])
        back = self.calls.setdefault((key or name) + ".backward", []) if hasattr(count, "backward") else None

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            store.append(count(*args, **kwargs))
            out = original(*args, **kwargs)
            if back is not None and out.requires_grad:
                args_ = args
                out.register_hook(lambda grad: back.append(count.backward(*args_, **kwargs)))
            return out

        self._set(module, name, wrapped, original)

    def _set(self, obj, attr, new, old):
        object.__setattr__(obj, attr, new)
        self._undo.append((obj, attr, old))

    def undo(self):
        for obj, attr, old in reversed(self._undo):
            object.__setattr__(obj, attr, old)
        self._undo.clear()
