"""Host-side video decode, preprocessing and encode.

Port of ``motionclone_tpu/io/video.py`` (t2v part).  Decoding and encoding
are OpenCV's (``cv2``, imported inside the two codec functions only, so the
rest of the port runs without it); frame sampling and the align-corners
bilinear resize are numpy, the numpy branch of
``motionclone_tpu/io/hostops.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


_NO_CV2 = "video decode and encode need OpenCV (the cv2 module), which is not installed"


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
