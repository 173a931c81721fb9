"""The program's spans (`cvpr23_lfdm_torch/utils/tracing.py`) on the CPU at
a tiny config: off without a profiler (the shared no-op), function scope
under one (no device copy), the serving call's and the DM step's spans
nested on one thread at their layer boundaries, the outputs the same bits
with and without a profiler running, and `utils/profiling.py::span_table`
on a hand-made profile."""

import copy
import dataclasses

import pytest
import torch
from torch._C._profiler import RecordScope
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
from cvpr23_lfdm_torch.utils import profiling, tracing
from test_torch_cli import tiny_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof) -> list:
    """`(name, start, end, thread)` of the profile's `lfdm::` host events,
    by start."""
    out = [(e.name().removeprefix(tracing.PREFIX), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _assert_nested(spans, parents: dict) -> None:
    """Each span lies inside one span of its parent's name on its thread."""
    for name, a, b, thread in spans:
        if name in parents:
            assert any(p == parents[name] and pa <= a and b <= pb and pt == thread
                       for p, pa, pb, pt in spans), name


def _serving():
    cfg = tiny_cfg("xla")
    torch.manual_seed(0)
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    d, s = cfg.diffusion, cfg.lfae.frame_shape
    g = torch.Generator().manual_seed(1)
    shape = (1, d.num_frames, d.img_size, d.img_size, 3)
    x = {"sample_img": torch.rand(1, s, s, 3, generator=g), "cond": torch.randn(1, d.cond_dim, generator=g),
         "init_img": torch.randn(shape, generator=g),
         "noise_seq": torch.randn((d.sampling_timesteps,) + shape, generator=g)}
    return cfg, model, x


def _trainer():
    cfg = tiny_cfg("xla")
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, sampling_timesteps=2))
    torch.manual_seed(0)
    tr = DMTrainer(cfg, steps_per_epoch=2, device="cpu")
    seed_lfae_weights([tr.model.region_predictor, tr.model.bg_predictor, tr.model.generator], 4)
    state = tr.init_state(seed=1)
    d, s = cfg.diffusion, cfg.lfae.frame_shape
    g = torch.Generator().manual_seed(2)
    vid = torch.rand(2, d.num_frames, s, s, 3, generator=g)
    batch = {"ref_img": vid[:, 0].clone(), "real_vid": vid, "cond": torch.randn(2, d.cond_dim, generator=g)}
    draws = {"t": torch.tensor([3, 40]), "noise": torch.randn(2, d.num_frames, d.img_size, d.img_size, 3,
                                                              generator=g),
             "null_mask": torch.tensor([False, True])}
    return tr, state, batch, draws


def test_span_is_the_shared_noop_without_a_profiler():
    assert tracing.span("sample_video") is tracing.OFF
    assert tracing.span("train_step", 3) is tracing.OFF
    with tracing.span("sample_video"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = tracing.span("sample_video")
        assert on is not tracing.OFF
        with on:
            pass
    assert tracing.span("sample_video") is tracing.OFF
    assert [s[0] for s in _spans(prof)] == ["sample_video"]


def test_span_is_function_scope_and_carries_the_number():
    """A function-scope range, which kineto keeps off the device timeline
    (a user-scope `record_function` range is mirrored there), with the
    step's number as its argument where the session records inputs."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with tracing.span("train_step", 7):
            with record_function("user_range"):
                pass
    events = {e.name: e for e in prof.events()}
    span, user = events["lfdm::train_step"], events["user_range"]
    assert span.scope == int(RecordScope.FUNCTION)
    assert user.scope == int(RecordScope.USER_SCOPE)
    assert span.kwinputs == {"number": 7}


def test_sample_video_records_its_spans_nested():
    cfg, model, x = _serving()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.sample_video(cond_scale=1.0, **x)
    spans = _spans(prof)
    steps = cfg.diffusion.sampling_timesteps
    names = [s[0] for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "sample_video": 1, "encode": 1, "sample": 1, "decode": 1,
        "sampler_step": steps, "denoise": steps, "threshold": steps}
    assert len({s[3] for s in spans}) == 1
    _assert_nested(spans, {"encode": "sample_video", "sample": "sample_video", "decode": "sample_video",
                           "sampler_step": "sample", "denoise": "sampler_step", "threshold": "sampler_step"})
    assert [n for n in names if n in ("encode", "sample", "decode")] == ["encode", "sample", "decode"]


def test_train_step_records_its_spans_in_order():
    tr, state, batch, draws = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(state, None, batch, **draws)
    spans = _spans(prof)
    top = [s for s in spans if s[0] in ("train_step", "pseudo_ground_truth", "forward", "backward", "optimizer")]
    assert [s[0] for s in top] == ["train_step", "pseudo_ground_truth", "forward", "backward", "optimizer"]
    root = top[0]
    for name, a, b, thread in top[1:]:
        assert root[1] <= a and b <= root[2] and thread == root[3], name
    for before, after in zip(top[1:], top[2:]):
        assert before[2] <= after[1], (before[0], after[0])
    # the monitoring x0 of the loss is thresholded inside the forward
    _assert_nested(spans, {"threshold": "forward"})


def test_outputs_are_the_same_bits_with_a_profiler_running():
    _, model, x = _serving()
    plain = model.sample_video(cond_scale=1.0, **x)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = model.sample_video(cond_scale=1.0, **x)
    for key in plain:
        assert torch.equal(plain[key], traced[key]), key

    tr, state, batch, draws = _trainer()
    saved = copy.deepcopy(tr.state_dict(state))
    results = []
    for traced in (False, True):
        tr.load_state_dict(copy.deepcopy(saved))
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _, m = tr.train_step(state, None, batch, **draws)
        else:
            _, m = tr.train_step(state, None, batch, **draws)
        results.append((m, {n: p.detach().clone() for n, p in tr.model.unet.named_parameters()}))
    (m0, p0), (m1, p1) = results
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


class _Ev:
    """The part of `torch.autograd._KinetoEvent` that `span_table` reads."""

    def __init__(self, name, start_us, dur_us, device=False, thread=1, corr=0):
        self._v = (name, start_us * 1000, dur_us * 1000, device, thread, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def test_span_table_ties_each_launch_to_its_spans():
    """A launch counts for the spans around it on its own thread, for
    `backward` on any thread; device activities with no launch (a mirrored
    user range) count for none; a parent's reading holds its children's."""
    events = [
        _Ev("lfdm::train_step", 0, 100), _Ev("lfdm::forward", 10, 20), _Ev("lfdm::backward", 40, 30),
        _Ev("cudaLaunchKernel", 12, 1, corr=1),
        _Ev("cudaLaunchKernel", 45, 1, thread=2, corr=2),  # autograd's device thread
        _Ev("cuLaunchKernelEx", 50, 1, corr=3),
        _Ev("elementwise_kernel", 15, 10, device=True, corr=1),
        _Ev("dgrad_kernel", 50, 20, device=True, corr=2),
        _Ev("lfdm::(anonymous namespace)::headpacked_dbias_kernel(...)", 70, 4, device=True, corr=3),
        _Ev("Optimizer.step#Adam.step", 80, 5, device=True, corr=99),
    ]
    prof = type("Prof", (), {})()
    prof.profiler = type("P", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    table = profiling.span_table(prof, per=2)
    assert table == {
        "backward": {"device_ms": 0.012, "launches": 1.0, "calls": 0.5},
        "forward": {"device_ms": 0.005, "launches": 0.5, "calls": 0.5},
        "train_step": {"device_ms": 0.007, "launches": 1.0, "calls": 0.5},
    }
