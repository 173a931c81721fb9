"""The readers of the program's own spans (`harness/program.py`) on a
hand-made profile: a launch counts for a span on the span's thread only,
except for `backward`, whose launches count on any thread; a gap counts
for `step_gap` only when the host was inside `lfdm::train_step` as it
began; a slice without the program's spans reads nothing."""

from __future__ import annotations

import os

from portbench.harness import core, program
from portbench.harness.trace import Trace
from portbench.tests.test_portbench_trace import US, Ev


class _Run:
    def __init__(self, events, units=1):
        self.trace = Trace(events, units=units)


def _step():
    """One DM step: the train step on thread 1 with its forward and
    backward spans; the backward's kernel launched from thread 2."""
    return [
        Ev("portbench::unit", 0, 100 * US),
        Ev("lfdm::train_step", 5 * US, 80 * US),
        Ev("lfdm::forward", 10 * US, 20 * US),
        Ev("cudaLaunchKernel", 12 * US, 1 * US, corr=1),
        Ev("lfdm::backward", 40 * US, 30 * US),
        Ev("cudaLaunchKernel", 45 * US, 1 * US, thread=2, corr=2),  # autograd's device thread
        Ev("cudaLaunchKernel", 50 * US, 1 * US, corr=3),  # the caller, inside the backward span
        Ev("cudaLaunchKernel", 90 * US, 1 * US, corr=4),  # after the step: the next batch's draw
        Ev("elementwise_kernel", 15 * US, 10 * US, cpu=False, corr=1),  # busy 15-25
        Ev("dgrad_kernel", 50 * US, 20 * US, cpu=False, corr=2),  # busy 50-70
        Ev("vectorized_elementwise_kernel", 70 * US, 5 * US, cpu=False, corr=3),  # busy 70-75
        Ev("reduce_kernel", 95 * US, 3 * US, cpu=False, corr=4),  # busy 95-98
    ]


def test_backward_counts_launches_on_any_thread_the_others_on_their_own():
    events = _step()
    run = _Run(events)
    assert program.span_ms(run, "forward") == 10 * US / 1e6
    assert program.span_ms(run, "backward") == 25 * US / 1e6  # thread 2's kernel and thread 1's
    assert program.span_launches(run, "backward") == 2
    assert program.span_launches(run, "train_step") == 2  # thread 1's launches in it: corr 1 and 3
    # a span on the launching thread's neighbour does not take its launch
    moved = [Ev("lfdm::forward", 44 * US, 10 * US, thread=3) if e.name() == "lfdm::forward" else e for e in events]
    assert program.span_ms(_Run(moved), "forward") == 0.0
    assert program.span_ms(_Run(events, units=2), "backward") == 12.5 * US / 1e6


def test_step_gap_counts_the_gaps_that_began_inside_the_train_step():
    run = _Run(_step())
    # idle 0-15 (began before the step), 25-50 (inside it), 75-95 (began
    # at 75, inside it), 98-100 (after it)
    assert program.gap_ms(run, "train_step") == 45 * US / 1e6
    idle = program.idle_by_span(run.trace)
    assert idle == {"forward": 25 * US / 1e9, "train_step": 20 * US / 1e9, program.NO_SPAN: 17 * US / 1e9}


def test_a_slice_without_the_program_spans_reads_nothing():
    run = _Run([e for e in _step() if not e.name().startswith("lfdm::")])
    for name in ("forward", "backward", "optimizer", "encode"):
        assert program.span_ms(run, name) is None and program.span_launches(run, name) is None
    assert program.gap_ms(run, "train_step") is None
    for metric in ("forward_ms.dm_train", "backward_ms.dm_train", "optim_ms.dm_train", "step_gap_ms.dm_train",
                   "encode_ms.serve", "decode_ms.serve", "denoise_ms.serve", "threshold_ms.serve",
                   "denoise_launches.serve"):
        reader = core.import_file(os.path.join(core.HERE, "metrics", metric + ".py"), "t_" + metric)
        assert reader.read(run) is None, metric
