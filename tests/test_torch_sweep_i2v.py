"""The port's i2v sweep against the JAX package's, on the CPU in f32.

tests/test_torch_sweep.py's helpers on tests/test_torch_runtime.py's
``i2v_dir`` (the synthetic model directory plus SparseCtrl checkpoints and
a condition PNG), the RGB flavour: a batch of 2 examples with different
``controlnet_scale``s, so the scale goes in as one per example, (B, 1, 1,
1, 1).  The JAX sweep runs once, in a module-scoped fixture, and the port
takes JAX's noise through the ``utils.rng.draw_normal`` seam.  The final
latents agree with JAX's within atol = rtol = 2e-3 (the sampling parity
tolerance), each batched example equals its own ``run_example`` run within
atol = rtol = 1e-4, and mixed counts of condition images raise."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from motionclone_tpu.config import Example as JExample
from motionclone_tpu_torch.config import Example
from motionclone_tpu_torch.pipeline import runner
from motionclone_tpu_torch.pipeline import sweep as tsweep
from motionclone_tpu_torch.utils import rng as trng
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_runtime import SD, _jax_draw, i2v_dir, model_dir  # noqa: F401
from test_torch_sweep import (  # noqa: F401
    SAMPLING_TOL,
    SERIAL_TOL,
    _cfg,
    _jax_sweep,
    _port_sweep,
    _serial,
    sweep_dir,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (video, prompt, seed, controlnet_scale): one condition image each
I2V = (("va.mp4", "a cat running", 42, 0.5), ("vb.mp4", "a dog", 7, 1.3))


@pytest.fixture(scope="module")
def i2v(i2v_dir, sweep_dir):  # noqa: F811
    root = i2v_dir
    jax_run = _jax_sweep(root, "inference_latent.yaml",
                         [JExample(v, p, s, condition_image_paths=("cond.png",),
                                   image_index=(1,), controlnet_scale=c)
                          for v, p, s, c in I2V], "jax_i2v")
    examples = [Example(v, p, s, condition_image_paths=("cond.png",), image_index=(1,),
                        controlnet_scale=c) for v, p, s, c in I2V]
    rt = runner.MotionCloneRuntime(os.path.join(root, SD), _cfg(root, "inference_latent.yaml"),
                                   device="cpu", dtype=torch.float32, config_root=root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trng, "draw_normal", _jax_draw)
        port = _port_sweep(rt, root, examples, "port_i2v")
        serial = _serial(rt, root, examples, "serial_i2v")
    return dict(rt=rt, examples=examples, jax=jax_run, port=port, serial=serial)


def test_i2v_sweep_with_per_example_scales_equals_jax(i2v):
    got, want = i2v["port"]["latents"], i2v["jax"]["latents"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **SAMPLING_TOL)
    assert [os.path.basename(p) for p in i2v["port"]["paths"]] == \
        [os.path.basename(p) for p in i2v["jax"]["paths"]]
    assert "condition" in i2v["rt"].timings


def test_i2v_batched_examples_equal_their_serial_runs(i2v):
    for got, want in zip(i2v["port"]["latents"], i2v["serial"]):
        torch.testing.assert_close(got, want, **SERIAL_TOL)
    # the scales differ, so the two examples' conditioning does too
    assert not torch.allclose(i2v["serial"][0], i2v["serial"][1])


def test_i2v_mixed_condition_counts_raise(i2v, tmp_path):
    mixed = [i2v["examples"][0], dataclasses.replace(
        i2v["examples"][1], condition_image_paths=("cond.png", "cond.png"),
        image_index=(0, 2))]
    with pytest.raises(ValueError, match="uniform condition-image count"):
        tsweep.run_sweep(i2v["rt"], mixed, motion_rep_dir=str(tmp_path / "r"),
                         output_dir=str(tmp_path / "o"))
