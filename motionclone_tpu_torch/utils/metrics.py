"""Output fidelity metrics: PSNR and SSIM over frames and videos.

Port of ``motionclone_tpu/utils/metrics.py``, the same formulas in numpy on
the host.  SSIM is Wang et al. 2004's: an 11x11 Gaussian window of sigma
1.5 (``scipy.ndimage.gaussian_filter`` truncated at 3.5 sigma, reflected
at the borders), K1 = 0.01, K2 = 0.03, window-weighted (population)
moments, channels scored apart and averaged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.ndimage import gaussian_filter

_SIGMA = 1.5
_TRUNCATE = 3.5  # radius int(3.5 * 1.5 + 0.5) = 5: an 11x11 window


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB; ``inf`` for identical inputs."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _filt(x: np.ndarray) -> np.ndarray:
    return gaussian_filter(x, sigma=_SIGMA, truncate=_TRUNCATE, mode="reflect")


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0, k1: float = 0.01,
         k2: float = 0.03) -> float:
    """Mean structural similarity of two (H, W) or (H, W, C) images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    if a.ndim != 3:
        raise ValueError(f"expected (H, W[, C]), got {a.shape}")
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    scores = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x, mu_y = _filt(x), _filt(y)
        var_x = _filt(x * x) - mu_x * mu_x
        var_y = _filt(y * y) - mu_y * mu_y
        cov = _filt(x * y) - mu_x * mu_y
        num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
        den = (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
        scores.append(np.mean(num / den))
    return float(np.mean(scores))


def video_metrics(frames_a: np.ndarray, frames_b: np.ndarray,
                  data_range: float = 255.0) -> Dict[str, float]:
    """Per-frame PSNR and SSIM of two (F, H, W, C) clips, their means and
    minima over the clip, and the frame count."""
    if frames_a.shape != frames_b.shape:
        raise ValueError(f"shape mismatch: {frames_a.shape} vs {frames_b.shape}")
    psnrs = [psnr(fa, fb, data_range) for fa, fb in zip(frames_a, frames_b)]
    ssims = [ssim(fa, fb, data_range) for fa, fb in zip(frames_a, frames_b)]
    return {
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_min": float(np.min(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "ssim_min": float(np.min(ssims)),
        "frames": int(frames_a.shape[0]),
    }


def compare_videos(path_a: str, path_b: str) -> Dict[str, float]:
    """Decode two videos and score their common leading frames."""
    from motionclone_tpu_torch.io.video import read_video_frames

    frames_a, _ = read_video_frames(path_a)
    frames_b, _ = read_video_frames(path_b)
    n = min(len(frames_a), len(frames_b))
    if n == 0:
        raise ValueError("empty video")
    return video_metrics(np.asarray(frames_a[:n]), np.asarray(frames_b[:n]))
