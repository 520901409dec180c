"""The port's fidelity metrics and video grid against the JAX package's, on
the CPU.

* ``psnr``, ``ssim`` and ``video_metrics`` of
  ``motionclone_tpu_torch/utils/metrics.py`` against
  ``motionclone_tpu/utils/metrics.py`` on seeded uint8 frames (colour and
  grey, identical, noisy and inverted), within 1e-12; the same refusals;
* ``compare_videos`` on two written mp4s equals JAX's on the same files;
* ``io/video.write_video_grid`` against JAX's on the same batch (uint8 and
  float, a padded last row): the decoded frames are equal."""

import os

import numpy as np
import pytest

from motionclone_tpu.io import video as jvideo
from motionclone_tpu.utils import metrics as jm
from motionclone_tpu_torch.io import video as tvideo
from motionclone_tpu_torch.utils import metrics as tm


def _frames(seed, shape=(3, 24, 32, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _pairs():
    a = _frames(0)
    r = np.random.default_rng(1)
    noisy = np.clip(a.astype(np.int16) + r.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    return {"identical": (a, a.copy()), "noisy": (a, noisy), "inverted": (a, 255 - a),
            "unrelated": (a, _frames(2)), "grey": (a[..., 0], noisy[..., 0])}


@pytest.mark.parametrize("case", sorted(_pairs()))
def test_frame_metrics_equal_jax(case):
    a, b = _pairs()[case]
    for fa, fb in zip(a, b):
        for fn in ("psnr", "ssim"):
            want, got = getattr(jm, fn)(fa, fb), getattr(tm, fn)(fa, fb)
            if np.isinf(want):
                assert got == want
            else:
                assert abs(got - want) <= 1e-12, (fn, got, want)
        # a data range other than 255 enters both formulas alike
        assert abs(tm.ssim(fa / 255.0, fb / 255.0, data_range=1.0)
                   - jm.ssim(fa / 255.0, fb / 255.0, data_range=1.0)) <= 1e-12


@pytest.mark.parametrize("case", ["identical", "noisy", "inverted", "unrelated"])
def test_video_metrics_equal_jax(case):
    a, b = _pairs()[case]
    want, got = jm.video_metrics(a, b), tm.video_metrics(a, b)
    assert sorted(got) == sorted(want) and got["frames"] == 3
    for k, v in want.items():
        if np.isinf(v):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


def test_metrics_refuse_what_jax_refuses():
    a = _frames(3)
    for fn in (tm.psnr, tm.ssim, tm.video_metrics):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(a, a[:, :-1])
    with pytest.raises(ValueError, match="expected"):
        tm.ssim(a, a)  # (F, H, W, C) is no image


def _smooth_clip(seed):
    # low-frequency content survives the mp4 encode
    base = np.random.default_rng(seed).normal(size=(4, 4, 6, 3))
    return np.clip(np.kron(base, np.ones((1, 8, 8, 1))) * 40 + 128, 0, 255).astype(np.uint8)


def test_compare_videos_equals_jax(tmp_path):
    pa, pb = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    tvideo.write_video(pa, _smooth_clip(4))
    tvideo.write_video(pb, _smooth_clip(5))
    got = tm.compare_videos(pa, pb)
    assert got == jm.compare_videos(pa, pb)
    assert got["frames"] == 4 and 0 < got["ssim_mean"] < 1
    same = tm.compare_videos(pa, pa)
    assert same["psnr_mean"] == float("inf") and same["ssim_mean"] == 1.0


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_write_video_grid_equals_jax(tmp_path, dtype):
    r = np.random.default_rng(6)
    videos = r.uniform(0, 1, size=(5, 4, 32, 48, 3)).astype(np.float32)
    if dtype == "uint8":
        videos = (videos * 255).astype(np.uint8)
    paths = {name: str(tmp_path / name / "grid.mp4") for name in ("jax", "port")}
    jvideo.write_video_grid(paths["jax"], videos, n_rows=3, fps=8)
    tvideo.write_video_grid(paths["port"], videos, n_rows=3, fps=8)
    got, fps = tvideo.read_video_frames(paths["port"])
    want, _ = tvideo.read_video_frames(paths["jax"])
    # 5 videos, 3 to a row: 2 rows of 3, the last cell black
    assert got.shape == (4, 2 * 32, 3 * 48, 3) and fps == 8
    np.testing.assert_array_equal(got, want)
    assert os.path.getsize(paths["port"]) == os.path.getsize(paths["jax"])
    with pytest.raises(ValueError, match="expected"):
        tvideo.write_video_grid(paths["port"], videos[0])
