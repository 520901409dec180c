"""Host-side video decode, preprocessing and encode.

Port of ``motionclone_tpu/io/video.py``.  Decoding and encoding are
OpenCV's (``cv2``, imported inside the three codec functions only, so the
rest of the port runs without it); frame sampling and the align-corners
bilinear resize are numpy, the numpy branch of
``motionclone_tpu/io/hostops.py``.  The i2v condition images are resized
with :func:`resize_bilinear_pil`, Pillow's ``Image.BILINEAR`` resample in
numpy, bit for bit (the JAX package resizes them with Pillow).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


_NO_CV2 = ("video and image decode and encode need OpenCV (the cv2 module), which is "
           "not installed")


def read_video_frames(path: str) -> Tuple[np.ndarray, float]:
    """Decode all frames as RGB uint8 (N, H, W, 3); returns (frames, fps)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(_NO_CV2) from e
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from: {path}")
    return np.stack(frames), fps


def write_video(path: str, frames: np.ndarray, fps: int = 8) -> None:
    """Encode RGB uint8 (F, H, W, 3) to an mp4 (mp4v) at ``fps``."""
    if frames.dtype != np.uint8:
        raise ValueError("write_video expects uint8 frames")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(_NO_CV2) from e
    _, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer: {path}")
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def write_video_grid(path: str, videos: np.ndarray, n_rows: int = 6, fps: int = 8) -> None:
    """Tile a batch of videos (B, F, H, W, 3), uint8 or float in [0, 1],
    into one clip, ``n_rows`` videos to a row of the grid (the reference's
    ``save_videos_grid``; the last row is padded with black), and encode
    it with :func:`write_video`."""
    if videos.ndim != 5:
        raise ValueError(f"expected (B, F, H, W, 3), got {videos.shape}")
    if videos.dtype != np.uint8:
        videos = (np.clip(videos, 0.0, 1.0) * 255).astype(np.uint8)
    b, f, h, w, c = videos.shape
    cols = min(n_rows, b)
    rows = -(-b // cols)
    pad = rows * cols - b
    if pad:
        videos = np.concatenate([videos, np.zeros((pad, f, h, w, c), np.uint8)])
    # (rows * cols, F, H, W, 3) -> (F, rows * H, cols * W, 3)
    grid = (videos.reshape(rows, cols, f, h, w, c).transpose(2, 0, 3, 1, 4, 5)
            .reshape(f, rows * h, cols * w, c))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_video(path, grid, fps=fps)


def sample_indices(total_frames: int, video_length: int) -> np.ndarray:
    """``video_length`` frame indices spread evenly over the clip."""
    return np.linspace(0, total_frames - 1, video_length).astype(np.int64)


def resize_bilinear_align_corners(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize with align_corners=True semantics (the reference's
    ``F.interpolate(..., mode="bilinear", align_corners=True)``).
    Input (N, H, W, C); output (N, height, width, C) float32."""
    _, h, w, _ = frames.shape
    frames = frames.astype(np.float32)
    if (h, w) == (height, width):
        return frames

    def grid(out_size, in_size):
        if out_size == 1:
            return np.zeros(1, dtype=np.float32)
        scale = (in_size - 1) / (out_size - 1)
        return np.arange(out_size, dtype=np.float32) * scale

    ys, xs = grid(height, h), grid(width, w)
    y0, x0 = np.floor(ys).astype(np.int64), np.floor(xs).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    rows0, rows1 = frames[:, y0], frames[:, y1]
    top = rows0[:, :, x0] * (1 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1 - wx) + rows1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def preprocess_video(path: str, height: int, width: int, video_length: int) -> np.ndarray:
    """Decode, sample ``video_length`` frames, resize, scale to [-1, 1]:
    float32 (video_length, height, width, 3)."""
    frames, _ = read_video_frames(path)
    picked = frames[sample_indices(len(frames), video_length)]
    resized = resize_bilinear_align_corners(picked, height, width)
    return (resized / np.float32(127.5) - np.float32(1.0)).astype(np.float32)


def read_image_rgb(path: str) -> np.ndarray:
    """Decode an image file as RGB uint8 (H, W, 3): an alpha channel is
    dropped, grey and palette images are expanded to RGB (as Pillow's
    ``convert("RGB")``); the EXIF orientation is not applied (Pillow's
    ``open`` does not apply it either)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(_NO_CV2) from e
    if not os.path.isfile(path):
        raise FileNotFoundError(f"image not found: {path}")
    bgr = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise IOError(f"cannot decode image: {path}")
    return np.ascontiguousarray(bgr[..., ::-1])


# Pillow's fixed-point resampling (libImaging/Resample.c): 8-bit samples,
# coefficients with 32 - 8 - 2 = 22 fractional bits
_PRECISION_BITS = 22


def _pil_coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear (triangle) filter
    over the whole input, then ``normalize_coeffs_8bpc``: per output pixel
    the first input index and the integer weights, shape (out, ksize)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)  # antialias when downsampling
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero; the clamp at 0 makes it a floor
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    w = np.abs((x + xmin[:, None] - centers[:, None] + 0.5) / filterscale)
    w = np.where((w < 1.0) & (x < xmax[:, None]), 1.0 - w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    kk = np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)  # w >= 0
    return xmin, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of Pillow's 8-bit resample along ``axis`` of a
    uint8 (H, W, C) image: rounded fixed-point sums, clipped to uint8."""
    in_size = img.shape[axis]
    xmin, kk = _pil_coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear_pil(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's ``Image.resize((width, height), Image.BILINEAR)`` of a uint8
    (H, W, C) image, bit for bit: a horizontal pass, then a vertical pass on
    its uint8 result (a pass whose size does not change is skipped)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError("resize_bilinear_pil expects a uint8 (H, W, C) image")
    if img.shape[1] != width:
        img = _pil_pass(img, width, axis=1)
    if img.shape[0] != height:
        img = _pil_pass(img, height, axis=0)
    return img


def load_condition_images(paths, height: int, width: int) -> np.ndarray:
    """The i2v condition images: RGB in [0, 1], float32 (N, height, width,
    3), each decoded by :func:`read_image_rgb` and resized as Pillow's
    bilinear resize does."""
    imgs = [resize_bilinear_pil(read_image_rgb(p), height, width) for p in paths]
    if not imgs:
        raise ValueError("no condition images given")
    return np.stack(imgs).astype(np.float32) / np.float32(255.0)
