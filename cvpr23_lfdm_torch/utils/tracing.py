"""The program's spans: host ranges at the layer boundaries of serving and
DM training, recorded only while a `torch.profiler` session is running.

`span(name)` opens a range named `lfdm::<name>`. Tracing is on exactly
while a profiler session is active, as the profiler's own enabled flag
says; there is no switch of the program's. On, the range is a
function-scope `RecordFunction`: a host event of the profile, on the
thread that opened it, and a child's interval lies inside its parent's.
Function scope keeps it off the device timeline: kineto mirrors a
user-scope range (`torch.profiler.record_function`) there as a
`gpu_user_annotation`, which a reader of device activity would count as
device time. Off, `span` reads the flag and returns one shared no-op
context.

A device activity belongs to a span when the runtime call that launched it
(tied to it by its CUDA correlation id) ran inside the span on the span's
thread. The backward's kernels are the exception: autograd launches them
from its device thread while the calling thread waits inside
`lfdm::backward`.

The spans: `sample_video` (a serving call) with `encode`, `sample` (one
`sampler_step` per step, each with its `denoise` and `threshold`) and
`decode`; `train_step` (a DM step) with `pseudo_ground_truth`, `forward`,
`backward` and `optimizer`.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler

PREFIX = "lfdm::"
ANY_THREAD = ("backward",)  # spans whose kernels another thread launches
OFF = contextlib.nullcontext()


def span(name: str, number: int | None = None):
    """The range `lfdm::<name>` while a profiler session is active, else
    the shared no-op `OFF`. `number` (a step's) is recorded as the range's
    argument `number` where the session records inputs (`record_shapes`)."""
    if not profiler._is_profiler_enabled:
        return OFF
    if number is None:
        return _RecordFunctionFast(PREFIX + name)
    return _RecordFunctionFast(PREFIX + name, keyword_values={"number": number})
