"""The SDXL family (``families/sdxl_animatediff.py``) through the harness
unchanged, at a tiny SDXL-shaped size on the CPU: a run is correct against
the plain reference (``reference/sdxl_nets.py``, ``reference/sdxl_job.py``)
with ``pooled`` among its numbers, the fp8 control and planted faults (a
DDIM step that returns its state, a wrong crop in the size and crop ids)
are not (against limits of three times a sound run's readings, as
``test_bench_h100_faults.py`` sets them), a traced run reads its per-layer
metrics and the two new readers read nothing where they have nothing to
read; and the configuration is pinned at its published widths (its job
FLOPs and its parameters)."""

import copy
import json
import os
import time

import pytest
import torch

from bench_h100 import check, harness, inputs
from bench_h100.work import bounds

SEED = 2 ** 31 + 2020
CELL = "t2v_camera_xl.b1"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(limits=None) -> harness.Cell:
    """The cell with the configuration at tiny widths (3 levels, depths
    [0, 1, 2], 8-wide heads, tiny towers and VAE) and the schedule cut to 6
    steps at 64 x 64 x 4."""
    real = harness.load_cell(CELL)
    c = copy.deepcopy(real.config)
    c["unet"].update(block_out_channels=[16, 16, 32], norm_num_groups=4, cross_attention_dim=32,
                     attention_head_dim=[2, 2, 4], transformer_layers_per_block=[0, 1, 2],
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=64)
    c["unet"]["motion_module"].update(num_attention_heads=2, norm_num_groups=4)
    c["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
    for key, proj in (("text_encoder", None), ("text_encoder_2", 16)):
        c[key].update(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                      intermediate_size=32, projection_dim=proj)
    t = copy.deepcopy(real.traffic)
    t["schedule"].update(inference_steps=6, guidance_steps=3, warm_up_steps=1, cool_up_steps=1)
    t["video"].update(width=64, height=64, frames=4)
    t["check"].update(guided_steps=1, vanilla_steps=1)
    return harness.Cell(CELL, c, t, real.limits if limits is None else limits,
                        real.end_to_end, real.per_layer)


def run(cell, trace=False, control=False):
    return harness.run(cell, SEED, 0.0, trace, "cpu", time.perf_counter(), control=control)


@pytest.fixture(scope="module")
def sound():
    """A sound run's numbers, and limits of three times each."""
    numbers = {k: v["value"] for k, v in run(tiny_cell(limits={}))["checks"].items()}
    return numbers, {k: 3 * v + 1e-6 for k, v in numbers.items()}


def test_a_tiny_sdxl_run_is_correct_and_the_control_is_not(sound):
    numbers, limits = sound
    assert set(numbers) == set(harness.load_cell(CELL).limits)  # pooled among them
    out = run(tiny_cell(limits=limits), control=True)
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert not check.verdict(out["control"], limits)
    assert out["control"]["pooled"] > limits["pooled"] and out["control"]["text"] > limits["text"]


def test_a_ddim_step_that_returns_its_state_is_caught(sound, monkeypatch):
    from motionclone_tpu_torch.pipeline import motionclone as mc

    _, limits = sound
    monkeypatch.setattr(mc, "ddim_step", lambda params, model_output, t, tp, sample, **kw: sample)
    out = run(tiny_cell(limits=limits))
    assert not out["correct"]
    assert out["checks"]["guided"]["value"] > limits["guided"]


def test_a_wrong_crop_in_the_programs_time_ids_is_caught(sound, monkeypatch):
    """The checked steps take their size and crop ids from the traffic's
    video, not from the program, so a wrong id row fails them."""
    from motionclone_tpu_torch.pipeline import motionclone as mc

    _, limits = sound
    right = mc.MotionClonePipeline.time_ids

    def wrong(self, batch):
        ids = right(self, batch)
        ids[:, 2] = 16.0  # a crop at the top
        return ids

    monkeypatch.setattr(mc.MotionClonePipeline, "time_ids", wrong)
    out = run(tiny_cell(limits=limits))
    assert not out["correct"]
    assert out["checks"]["guided"]["value"] > limits["guided"]


def test_a_traced_run_reads_its_metrics_and_the_new_readers_read_nothing_on_the_cpu(sound):
    _, limits = sound
    out = run(tiny_cell(limits=limits), trace=True)
    assert out["correct"]
    # the step record holds no device time on the CPU, and no kernel runs there
    assert set(out["metrics"]) == {"guided_step_ms.sweep", "vanilla_step_ms.sweep", "mfu.sweep"}
    for name in ("guided_recompute_ms", "flash_roofline"):
        reader = harness.load_reader(f"{name}.sweep")
        assert reader(harness.RunData({}, 1.0, 1, lambda: 1.0,
                                      type("T", (), {"calls": []})())) is None


def test_the_recompute_reader_sums_the_backward_spans_of_each_guided_step(monkeypatch):
    from motionclone_tpu_torch.utils import trace

    def span(name, ms, children=(), **attrs):
        s = trace.Span(name, attrs, 0)
        s._ms, s.children = ms, list(children)
        return s

    steps = [span("step", 900.0, [span("unet_guided_bwd", 400.0, [
        span("unet_guided_recompute", 10.0 + i), span("unet_guided_recompute", 20.0)])],
        guided=True) for i in range(2)] + [span("step", 300.0, guided=False)]
    fake = trace.Run(None)
    fake.steps = steps
    monkeypatch.setattr(trace, "runs", lambda: [fake])
    got = harness.load_reader("guided_recompute_ms.sweep")(harness.RunData({}, 1.0, 1,
                                                                          lambda: 1.0))
    assert got == pytest.approx((30.0 + 31.0) / 2)


def test_the_flash_reader_reads_kernels_1_and_2_alone():
    from bench_h100.trace import Call

    f, b = bounds.flash_fwd((16, 4096, 640), (16, 4096, 640), 10), bounds.flash_bwd(
        (16, 4096, 640), (16, 4096, 640), 10)
    calls = [Call("flash_fwd", "attention", *f, 2e-3), Call("flash_bwd", "attention", *b, 5e-3),
             Call("temporal_fwd", "attention", 1e12, 1e9, 1.0)]
    got = harness.load_reader("flash_roofline.sweep")(
        harness.RunData({}, 1.0, 1, lambda: 1.0, type("T", (), {"calls": calls})()))
    want = 100 * (bounds.bound_s(*f) + bounds.bound_s(*b)) / 7e-3
    assert got == pytest.approx(want)


def test_the_configuration_is_pinned_at_its_published_widths():
    """SDXL base 1.0's UNet with the AnimateDiff-SDXL motion modules (2.80 B
    parameters), bigG (0.69 B), CLIP-L (0.12 B), the VAE (0.08 B); a job's
    FLOPs at 1024 x 1024 x 16 and the cell's 20-step schedule."""
    cell = harness.load_cell(CELL)
    nets = cell.family.networks(cell.config)
    assert {k: sum(p.numel() for p in m.parameters()) for k, m in nets.items()} == {
        "unet": 2_804_242_884, "vae": 83_653_863, "text_encoder": 123_060_480,
        "text_encoder_2": 694_659_840}
    assert cell.family.job_flops(cell.config, cell.traffic)["job"] == 6_390_091_179_912_192
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        entry = {c["name"]: c for c in json.load(fh)["configs"]}["sdxl-adxl-t2v"]
    assert entry["reduced"] == cell.config["reduced"]


def test_the_two_towers_frame_their_ids():
    cell = tiny_cell()
    fam = cell.family
    job = inputs.make_job(cell.traffic, fam, cell.config, SEED, 0, "cpu")
    ids_1, ids_2 = job.ids
    assert ids_1.shape == ids_2.shape == (3, 77)
    eos = cell.config["text_encoder"]["vocab_size"] - 1
    for row_1, row_2 in zip(ids_1, ids_2):
        n = int(row_2.argmax()) + 1  # BOS, the prompt, EOS (the pooled position)
        assert row_2[n - 1] == eos and (row_2[n:] == 0).all()  # bigG pads with 0
        assert (row_1[n - 1:] == eos).all() and torch.equal(row_1[:n], row_2[:n])
