"""``correct`` comes out false when the timed path is broken underneath,
and for the control, at a tiny size on the CPU.

Each test drives a whole run (everything but the look for a card) with a
fault planted in the program, against limits set at three times a sound
run's readings at the same size and seed: a fault has to push some number
past three times its sound reading.  (The cells' own limits are set from
readings on the card at the cells' sizes.)  The fault of an exchange
between chips does not apply: every cell runs on one chip.
"""

import time

import pytest
import torch

from bench_h100 import check, harness
from bench_h100.tests.tiny import tiny_cell

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, control=False):
    return harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(), control=control)


@pytest.fixture(scope="module")
def limits():
    """Three times each number of a sound run, per cell."""
    out = {}
    for name in ("t2v_camera.b2", "i2v_rgb.b1"):
        sound = run(tiny_cell(name, limits={}))["checks"]
        out[name] = {k: 3 * v["value"] + 1e-6 for k, v in sound.items()}
    return out


def unchanged_state(monkeypatch):
    from motionclone_tpu_torch.pipeline import motionclone as mc

    monkeypatch.setattr(mc, "ddim_step", lambda params, model_output, t, tp, sample, **kw: sample)


def half_the_batch(monkeypatch):
    """The guidance loss over the first half of the batch, its mean taken
    over that half: the other examples get no guidance."""
    from motionclone_tpu_torch.pipeline import motionclone as mc

    loss = mc.motion_guidance_loss

    def first_half(probs, rep, group=None):
        b = next(iter(probs.values())).shape[0]
        h = max(1, b // 2)
        return loss({k: p[:h] for k, p in probs.items()},
                    {k: (v[:h], i[:h]) for k, (v, i) in rep.items()}, group) * (b / h)

    monkeypatch.setattr(mc, "motion_guidance_loss", first_half)


def altered_video(monkeypatch):
    """One frame of every decoded video negated where the decode produces it."""
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    decode = MotionClonePipeline.decode_latents

    def altered(self, latents):
        video = decode(self, latents).clone()
        video[0] = -video[0]
        return video

    monkeypatch.setattr(MotionClonePipeline, "decode_latents", altered)


def altered_text(monkeypatch):
    """The first prompt's embedding altered where CLIP produces it."""
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    encode = MotionClonePipeline.encode_text

    def altered(self, ids):
        emb = encode(self, ids).clone()
        emb[0] = emb[0] * 1.1
        return emb

    monkeypatch.setattr(MotionClonePipeline, "encode_text", altered)


@pytest.mark.parametrize("cell, fault", [
    ("t2v_camera.b2", unchanged_state), ("i2v_rgb.b1", unchanged_state),
    ("t2v_camera.b2", half_the_batch),
    ("t2v_camera.b2", altered_video), ("i2v_rgb.b1", altered_video),
    ("t2v_camera.b2", altered_text),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_fails_the_check(cell, fault, limits, monkeypatch):
    sound = run(tiny_cell(cell, limits=limits[cell]))
    assert sound["correct"]
    fault(monkeypatch)
    broken = run(tiny_cell(cell, limits=limits[cell]))
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("cell", ["t2v_camera.b2", "i2v_rgb.b1"])
def test_the_fp8_control_fails_the_check(cell, limits):
    out = run(tiny_cell(cell, limits=limits[cell]), control=True)
    assert out["correct"]
    assert not check.verdict(out["control"], limits[cell])
