"""Typed, frozen configuration of the PyTorch port.

The port's own copy of the topology, schedule and workload dataclasses of
``motionclone_tpu/config.py`` (same fields, same defaults), plus the tiny test
topologies.  YAML/JSONL loading is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MotionModuleConfig:
    """Temporal motion-module topology (AnimateDiff ``motion_module_kwargs``)."""

    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    # the reference model_config.yaml omits this key, so 24 applies
    temporal_position_encoding_max_len: int = 24
    temporal_attention_dim_div: int = 1
    zero_initialize: bool = True
    norm_num_groups: int = 32


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """AnimateDiff SD1.5 UNet3D topology.

    ``attention_head_dim`` follows the diffusers-legacy convention: it is the
    *number of heads* per spatial attention (head width = channels // heads).
    """

    sample_size: Optional[int] = None
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # number of heads (diffusers-legacy naming)
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_inflated_groupnorm: bool = True
    use_linear_projection: bool = False
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_module_decoder_only: bool = False
    motion_module: MotionModuleConfig = MotionModuleConfig()

    @property
    def num_heads(self) -> int:
        return self.attention_head_dim


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    """DDIM noise schedule (AnimateDiff model_config.yaml)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """One workload's knobs.  ``guidance_fraction`` is the YAML key
    ``guidance_scale``: the fraction of the 1000-step range reserved for
    guidance."""

    motion_module: str = ""
    dreambooth_path: str = ""
    model_config: str = ""
    cfg_scale: float = 7.5
    negative_prompt: str = ""
    positive_prompt: str = ""
    inference_steps: int = 100
    guidance_fraction: float = 0.3
    guidance_steps: int = 50
    warm_up_steps: int = 10
    cool_up_steps: int = 10
    motion_guidance_weight: float = 2000.0
    motion_guidance_blocks: Tuple[str, ...] = ("up_blocks.1",)
    add_noise_step: int = 400
    width: int = 512
    height: int = 512
    video_length: int = 16
    controlnet_path: str = ""
    controlnet_config: str = ""
    controlnet_scale: float = 1.0
    adapter_lora_path: str = ""
    adapter_lora_scale: float = 1.0

    @property
    def vanilla_steps(self) -> int:
        return self.inference_steps - self.guidance_steps

    def validate(self) -> None:
        if self.guidance_steps > self.inference_steps:
            raise ValueError(
                f"guidance_steps ({self.guidance_steps}) cannot exceed "
                f"inference_steps ({self.inference_steps})"
            )
        if not 0.0 <= self.guidance_fraction <= 1.0:
            raise ValueError(
                f"guidance_fraction must be in [0,1], got {self.guidance_fraction}"
            )
        if self.height % 8 or self.width % 8:
            raise ValueError("height and width must be divisible by 8")


def micro_unet_config() -> UNet3DConfig:
    """A 2-level UNet3D: a CrossAttn and a plain block on each side, motion
    modules at every layer, the ``up_blocks.1`` guidance block, skip concats
    and one down/upsampler."""
    return UNet3DConfig(
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        block_out_channels=(8, 16),
        layers_per_block=1,
        norm_num_groups=4,
        cross_attention_dim=16,
        attention_head_dim=2,
        motion_module=MotionModuleConfig(
            num_attention_heads=2,
            norm_num_groups=4,
        ),
    )


def tiny_unet_config() -> UNet3DConfig:
    """A miniature UNet3D with the full topology's shape, for CPU tests."""
    return UNet3DConfig(
        block_out_channels=(8, 16, 16, 16),
        layers_per_block=1,
        norm_num_groups=4,
        cross_attention_dim=16,
        attention_head_dim=2,
        motion_module=MotionModuleConfig(
            num_attention_heads=2,
            norm_num_groups=4,
        ),
    )
