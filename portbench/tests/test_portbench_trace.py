"""The trace reader on a hand-made profile: launches tied to their device
activity by correlation id, spans by launch time and thread (a launch on
another thread is not the span's), the busy share, the groups and the idle
gaps."""

from __future__ import annotations

from torch.autograd import DeviceType

from portbench.harness.trace import Trace


class Ev:
    """The part of `torch.autograd._KinetoEvent` the reader uses."""

    def __init__(self, name, start, dur, cpu=True, thread=1, corr=0, seq=-1):
        self._v = (name, start, dur, cpu, thread, corr, seq)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CPU if self._v[3] else DeviceType.CUDA

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def sequence_nr(self):
        return self._v[6]


US = 1000  # ns


def _profile():
    return [
        Ev("portbench::unit", 0, 100 * US),
        Ev("portbench::sample", 10 * US, 20 * US),
        Ev("aten::conv2d", 11 * US, 5 * US, seq=42, corr=7),  # an op id that collides with a CUDA one
        Ev("cudaLaunchKernel", 12 * US, 1 * US, corr=7),
        Ev("cuLaunchKernelEx", 25 * US, 1 * US, corr=8),  # a ctypes launch inside the span
        Ev("cudaLaunchKernel", 50 * US, 1 * US, corr=9),  # outside it
        Ev("autograd::engine::evaluate_function: ConvolutionBackward0", 60 * US, 10 * US, thread=2, seq=42),
        Ev("cudaLaunchKernel", 61 * US, 1 * US, thread=2, corr=10),
        Ev("portbench::sample", 20 * US, 10 * US, cpu=False),  # the span's device copy: not an activity
        Ev("implicit_gemm_kernel", 20 * US, 10 * US, cpu=False, corr=7),
        Ev("fused_temporal_layer_mma_kernel", 30 * US, 5 * US, cpu=False, corr=8),
        Ev("vectorized_elementwise_kernel", 55 * US, 5 * US, cpu=False, corr=9),
        Ev("dgrad_kernel", 65 * US, 15 * US, cpu=False, corr=10),
    ]


def test_attribution():
    tr = Trace(_profile(), units=1)
    assert tr.launches == 4
    assert tr.span_us("sample") == 15.0  # the conv and the ctypes kernel
    assert tr.span_us("nothing") is None
    assert tr.group_us("conv_gemm") == 25.0
    assert tr.total_us() == 35.0


def test_busy_and_gaps():
    tr = Trace(_profile(), units=1)
    assert tr.window_s == 100 * US / 1e9
    assert abs(tr.busy_s - 35 * US / 1e9) < 1e-12
    gaps = dict(tr.idle_gaps())
    assert abs(sum(gaps.values()) - 65 * US / 1e9) < 1e-12
    assert set(gaps) <= {"unit", "sample"}
    assert dict(tr.device_ops())["conv_gemm"] == 25 * US / 1e9


def test_device_only_slice_takes_its_window():
    tr = Trace([e for e in _profile() if not e._v[3]], units=1, window_s=0.5)
    assert tr.window_s == 0.5 and tr.launches == 4
