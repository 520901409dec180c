"""DDIM schedule and step math with score (motion) guidance.

Port of ``motionclone_tpu/diffusion/ddim.py``: host-side schedule
construction in numpy, and pure functions of tensors for the step.  All
step math runs in float32 whatever the activation dtype; results are cast
back to the sample's dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from motionclone_tpu_torch.config import NoiseScheduleConfig


class DDIMParams(NamedTuple):
    """Precomputed schedule constants (float32 tensors on one device)."""

    alphas_cumprod: torch.Tensor  # [num_train_timesteps]
    final_alpha_cumprod: torch.Tensor  # scalar
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    clip_sample_range: float
    thresholding: bool
    dynamic_thresholding_ratio: float
    sample_max_value: float


def make_betas(cfg: NoiseScheduleConfig) -> np.ndarray:
    """Noise schedule betas (float64).  AnimateDiff/MotionClone use
    ``linear`` with beta_start=0.00085, beta_end=0.012."""
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return (
            np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, T, dtype=np.float64)
            ** 2
        )
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(T, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    raise ValueError(f"unknown beta_schedule: {cfg.beta_schedule}")


def make_ddim_params(
    cfg: NoiseScheduleConfig, device: torch.device | str = "cpu"
) -> DDIMParams:
    alphas_cumprod = np.cumprod(1.0 - make_betas(cfg))
    final = 1.0 if cfg.set_alpha_to_one else float(alphas_cumprod[0])
    return DDIMParams(
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32, device=device),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32, device=device),
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type,
        clip_sample=cfg.clip_sample,
        clip_sample_range=cfg.clip_sample_range,
        thresholding=cfg.thresholding,
        dynamic_thresholding_ratio=cfg.dynamic_thresholding_ratio,
        sample_max_value=cfg.sample_max_value,
    )


def build_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    guidance_steps: int = 0,
    guidance_fraction: float = 0.0,
    steps_offset: int = 1,
    spacing: str = "uneven",
) -> np.ndarray:
    """Descending int64 timestep sequence.

    ``uneven`` is MotionClone's guidance-weighted schedule: ``guidance_steps``
    timesteps over the top ``guidance_fraction`` of the train range, the rest
    over the bottom.  ``linspace`` / ``leading`` / ``trailing`` are the
    diffusers spacings."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > num_train_timesteps "
            f"({num_train_timesteps})"
        )
    if spacing == "uneven":
        split = int((1 - guidance_fraction) * num_train_timesteps)
        ts_guidance = (
            np.linspace(split, num_train_timesteps - 1, guidance_steps)
            .round()[::-1]
            .astype(np.int64)
        )
        ts_vanilla = (
            np.linspace(0, split - 1, num_inference_steps - guidance_steps)
            .round()[::-1]
            .astype(np.int64)
        )
        return np.concatenate([ts_guidance, ts_vanilla])
    if spacing == "linspace":
        return (
            np.linspace(0, num_train_timesteps - 1, num_inference_steps)
            .round()[::-1]
            .astype(np.int64)
        )
    if spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        return ts.astype(np.int64) + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        return np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1
    raise ValueError(f"unknown spacing: {spacing}")


def prev_timesteps(timesteps: np.ndarray) -> np.ndarray:
    """Previous timestep per position, read from the list, -1 after the last."""
    return np.concatenate([timesteps[1:], np.array([-1], dtype=timesteps.dtype)])


def add_noise(
    params: DDIMParams, timestep: int, x0: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """x_t = sqrt(a_t) x0 + sqrt(1-a_t) eps, in float32, cast back to x0's dtype."""
    a = params.alphas_cumprod[int(timestep)]
    x = a**0.5 * x0.float() + (1.0 - a) ** 0.5 * noise.float()
    return x.to(x0.dtype)


def threshold_sample(
    sample: torch.Tensor, ratio: float, max_value: float
) -> torch.Tensor:
    """Dynamic thresholding of predicted x0 (Imagen): per batch sample,
    s = quantile(|x0|, ratio) clamped to [1, max_value], x0 <- clip(x0, -s, s)/s."""
    x = sample.float().reshape(sample.shape[0], -1)
    s = torch.quantile(x.abs(), ratio, dim=1)
    s = s.clamp(1.0, max_value)[:, None]
    x = torch.maximum(torch.minimum(x, s), -s) / s
    return x.reshape(sample.shape).to(sample.dtype)


def _alpha_at(params: DDIMParams, t: int) -> torch.Tensor:
    """alphas_cumprod[t], with t == -1 mapping to final_alpha_cumprod."""
    return params.alphas_cumprod[int(t)] if t >= 0 else params.final_alpha_cumprod


def ddim_variance(params: DDIMParams, timestep: int, prev_timestep: int) -> torch.Tensor:
    """sigma_t^2 = (1-a_prev)/(1-a_t) * (1 - a_t/a_prev)."""
    a_t = _alpha_at(params, timestep)
    a_prev = _alpha_at(params, prev_timestep)
    return (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)


def ddim_step(
    params: DDIMParams,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    sample: torch.Tensor,
    *,
    eta: float = 0.0,
    score: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    variance_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One (optionally guided) DDIM update.

    Guidance enters on the predicted noise after the x0 prediction,
    ``eps <- eps - guidance_scale * sqrt(1-a_t) * score``, so the predicted
    x0 is unguided (MotionClone's customized scheduler step)."""
    out_dtype = sample.dtype
    sample = sample.float()
    model_output = model_output.float()

    a_t = _alpha_at(params, timestep)
    a_prev = _alpha_at(params, prev_timestep)
    beta_t = 1.0 - a_t

    if params.prediction_type == "epsilon":
        pred_x0 = (sample - beta_t**0.5 * model_output) / a_t**0.5
        pred_eps = model_output
    elif params.prediction_type == "sample":
        pred_x0 = model_output
        pred_eps = (sample - a_t**0.5 * pred_x0) / beta_t**0.5
    elif params.prediction_type == "v_prediction":
        pred_x0 = a_t**0.5 * sample - beta_t**0.5 * model_output
        pred_eps = a_t**0.5 * model_output + beta_t**0.5 * sample
    else:
        raise ValueError(f"unknown prediction_type: {params.prediction_type}")

    # thresholding takes precedence over clip_sample
    if params.thresholding:
        pred_x0 = threshold_sample(
            pred_x0, params.dynamic_thresholding_ratio, params.sample_max_value
        )
    elif params.clip_sample:
        pred_x0 = pred_x0.clamp(-params.clip_sample_range, params.clip_sample_range)

    variance = ddim_variance(params, timestep, prev_timestep)
    std_dev_t = eta * variance**0.5

    if score is not None:
        # classifier-style guidance, formula (14) of arXiv:2105.05233
        pred_eps = pred_eps - guidance_scale * (1.0 - a_t) ** 0.5 * score.float()

    pred_dir = (1.0 - a_prev - std_dev_t**2) ** 0.5 * pred_eps
    prev_sample = a_prev**0.5 * pred_x0 + pred_dir

    if eta > 0:
        if variance_noise is None:
            raise ValueError("eta > 0 requires variance_noise")
        prev_sample = prev_sample + std_dev_t * variance_noise.float()

    return prev_sample.to(out_dtype)
