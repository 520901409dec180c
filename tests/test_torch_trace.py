"""The port's spans and step record (``utils/trace.py``) on the CPU: how
spans nest in their run, the stream a run records on, what one tiny
``sample`` records a step (through the approx step cache, so that skip
steps are in it), the profiler's ranges and their clock, recording
switched off, and the ring of runs.  The tiny UNet3D (4 frames, 8x8 latents, 6 steps of which 3 guided)
with torch's own initialisation."""

import pytest
import torch

from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.pipeline import motionclone as tmc
from motionclone_tpu_torch.utils import trace
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS, GUIDED = 6, 3


@pytest.fixture(scope="module")
def s():
    torch.manual_seed(70)
    infer = tcfg.InferenceConfig(
        inference_steps=STEPS, guidance_steps=GUIDED, guidance_fraction=0.3, warm_up_steps=1,
        cool_up_steps=1, motion_guidance_weight=50.0, motion_guidance_blocks=("up_blocks.1",),
        add_noise_step=400, cfg_scale=7.5, width=64, height=64, video_length=4)
    unet = TUNet(tcfg.tiny_unet_config()).eval()
    fns = tmc.make_sampling_fns(unet, tcfg.NoiseScheduleConfig(), infer, step_interval=2,
                                step_extrap=1.0)
    video, noise, init = (torch.randn(1, 4, 8, 8, 4) for _ in range(3))
    uncond, cond = (torch.randn(1, 7, 16) for _ in range(2))
    rep = fns.extract(video, noise, uncond)
    return dict(fns=fns, args=(init, uncond, cond, rep))


def test_a_backward_span_hosts_the_spans_of_another_thread_and_annotate_marks_the_step():
    """Autograd runs a CUDA pass's backward on its own device thread: a span
    opened there, with no span of its own, belongs to the open span opened
    with ``backward=True``; ``annotate`` sets attributes on the innermost
    open span of a name."""
    import threading

    inner, lone = [], []

    def run_in_thread(name, out):
        def body():
            with trace.span(name) as sp:
                out.append(sp)
        worker = threading.Thread(target=body)
        worker.start()
        worker.join()

    with trace.span("sample"):
        with trace.span("step", index=0, guided=True, full=True) as step:
            with trace.span("unet_guided_bwd", backward=True) as bwd:
                run_in_thread("unet_guided_recompute", inner)
            trace.annotate("step", recomputed=1)
        run_in_thread("x", lone)
    assert bwd.children == inner and inner[0].name == "unet_guided_recompute"
    assert step.attrs == dict(index=0, guided=True, full=True, recomputed=1)
    assert lone == [None]  # no backward span open: another thread records nothing


def test_spans_nest_in_their_run_and_record_nothing_outside_one():
    with trace.span("sample") as sample:
        with trace.span("step", index=0, guided=True, full=True) as step:
            with trace.span("unet_plain") as plain:
                pass
        with trace.span("step", index=1, guided=False, full=False) as skip:
            pass
    run = trace.last_run()
    assert run.spans == [plain, step, skip, sample] and run.steps == [step, skip]
    assert sample.children == [step, skip] and step.children == [plain]
    assert skip.children == [] and plain.children == []
    assert step.attrs == dict(index=0, guided=True, full=True)
    assert all(x.host_ns >= 0 and x.device_ms is None for x in run.spans)
    assert sample.start_ns <= step.start_ns <= plain.start_ns <= plain.end_ns <= step.end_ns
    assert not run.profiled
    # a span left by an exception closes: the next sample opens a new run
    with pytest.raises(ValueError), trace.span("sample"):
        raise ValueError
    failed = trace.last_run()
    assert failed is not run and [x.name for x in failed.spans] == ["sample"]
    # a span outside a sample records nothing and opens no run
    with trace.span("controlnet") as outside, trace.span("unet_plain") as inner:
        pass
    assert outside is None and inner is None and trace.last_run() is failed


def test_a_run_records_on_the_stream_of_the_device_it_samples_on(monkeypatch):
    # a rank samples on a card that need not be the current device: the
    # run looks up that card's stream, and its spans' events go there
    streams, made = [], []

    class Stream:
        def __init__(self, device):
            self.device_index = device.index

    class Event:
        def __init__(self, enable_timing):
            self.at = None
            made.append(self)

        def record(self, stream):
            self.at = stream.device_index

        def elapsed_time(self, end):
            return 2.5

    def current_stream(device=None):
        assert device is not None, "the current device's stream was looked up"
        streams.append(torch.device(device))
        return Stream(torch.device(device))

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(trace, "_pools", {})
    with trace.span("sample", device=torch.device("cuda", 1)):
        with trace.span("step", index=0, guided=False, full=True) as step:
            pass
    assert streams == [torch.device("cuda", 1)]
    assert len(made) == 4 and {e.at for e in made} == {1}
    assert step.device_ms == 2.5
    assert len(trace._pools[1]) == 2  # a read span's events go back to the card's pool
    for x in trace.last_run().spans:
        x.device_ms
    assert len(trace._pools[1]) == 4


def test_a_tiny_sample_records_one_step_a_step_and_its_passes(s):
    s["fns"].sample(*s["args"])
    run = trace.last_run()
    flags = s["fns"].schedule()
    assert not flags.full.all()  # the step cache skips steps
    assert [x.attrs["index"] for x in run.steps] == list(range(STEPS))
    assert [x.attrs["guided"] for x in run.steps] == [i < GUIDED for i in range(STEPS)]
    assert [x.attrs["full"] for x in run.steps] == flags.full.tolist()
    for step in run.steps:
        names = [c.name for c in step.children]
        guided_full = step.attrs["guided"] and step.attrs["full"]
        assert ("unet_guided_fwd" in names) == ("unet_guided_bwd" in names) == guided_full
        assert names == (["unet_plain", "unet_guided_fwd", "unet_guided_bwd"] if guided_full
                         else ["unet_plain"] if step.attrs["full"] else [])
        assert step.host_ns >= sum(c.host_ns for c in step.children)
    assert run.spans[-1].name == "sample" and run.spans[-1].children == run.steps


def test_ranges_open_under_a_profiler_on_its_clock_and_never_without_one(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("sample") as sample:
            with trace.span("unet_plain") as plain:
                torch.ones(4).add_(1)
        with trace.span("controlnet"):  # outside a run: its range only
            pass
    assert trace.last_run().profiled
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(trace.PREFIX)}
    assert set(events) == {"motionclone/sample", "motionclone/unet_plain",
                           "motionclone/controlnet"}
    # host ranges, not user annotations (which the profiler copies onto the device)
    assert not any(ev.is_user_annotation() for ev in events.values())
    for span in (sample, plain):
        assert abs(events[trace.PREFIX + span.name].start_ns() - span.start_ns) < 1_000_000

    def refuse(name):
        raise AssertionError(f"a range {name} opened without a profiler")

    monkeypatch.setattr(trace, "_Range", refuse)
    with trace.span("sample"), trace.span("step", index=0, guided=False, full=True):
        pass
    with trace.span("controlnet"):  # outside a run
        pass
    assert not trace.last_run().profiled


def test_recording_off_records_nothing_and_samples_the_same_latents(s):
    on = s["fns"].sample(*s["args"])
    last = trace.last_run()
    trace.set_enabled(False)
    try:
        assert trace.span("sample") is trace.span("step", index=0)  # one shared no-op
        off = s["fns"].sample(*s["args"])
    finally:
        trace.set_enabled(True)
    assert trace.last_run() is last
    assert torch.equal(on, off)


def test_the_ring_keeps_the_last_runs():
    kept = []
    for _ in range(trace.RING + 2):
        with trace.span("sample"):
            pass
        kept.append(trace.last_run())
    assert trace.RING == 8
    assert trace.runs() == kept[-trace.RING:]
