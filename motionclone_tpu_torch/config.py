"""Typed, frozen configuration of the PyTorch port.

The port's own copy of the topology, schedule and workload dataclasses of
``motionclone_tpu/config.py`` (same fields, same defaults), their loaders
from the reference-format YAML and JSONL files (YAML through the port's own
``io/yaml_subset.py``), plus the tiny test topologies.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Tuple, Union

from motionclone_tpu_torch.io import yaml_subset


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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MotionModuleConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "attention_block_types" in kwargs:
            kwargs["attention_block_types"] = tuple(kwargs["attention_block_types"])
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """AnimateDiff UNet3D topology (SD1.5's by default; SDXL's with three
    levels, per-level heads and depths and the ``text_time`` embedding).

    ``attention_head_dim`` follows the diffusers-legacy convention: it is the
    *number of heads* per spatial attention (head width = channels // heads),
    one for every level or one per level.  ``transformer_layers_per_block``
    is the number of transformer layers in each spatial attention, one for
    every level or one per level; the mid block takes the last level's.
    The number of levels is ``len(block_out_channels)``.
    ``addition_embed_type`` "text_time" (SDXL) adds the embedding of the
    pooled text and the six size and crop ids (each through an
    ``addition_time_embed_dim``-wide sinusoid; ``projection_class_embeddings_input_dim``
    wide together) to the time embedding.  ``guided_recompute``: the
    differentiated pass keeps no transformer layer's activations, and its
    backward runs each layer again.
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
    # number of heads (diffusers-legacy naming): one, or one per level
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    guided_recompute: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_inflated_groupnorm: bool = True
    use_linear_projection: bool = False
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_module_decoder_only: bool = False
    motion_module: MotionModuleConfig = MotionModuleConfig()

    def __post_init__(self):
        for key in ("attention_head_dim", "transformer_layers_per_block"):
            v = getattr(self, key)
            if not isinstance(v, int) and len(v) != len(self.block_out_channels):
                raise ValueError(f"{key} {v!r}: one value, or one per level "
                                 f"({len(self.block_out_channels)})")
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unsupported addition_embed_type {self.addition_embed_type!r}")
        if self.addition_embed_type and not self.projection_class_embeddings_input_dim:
            raise ValueError("the text_time embedding needs "
                             "projection_class_embeddings_input_dim")

    @property
    def num_heads(self) -> int:
        """The head count of every level (a per-level list has none)."""
        if not isinstance(self.attention_head_dim, int):
            raise ValueError("attention_head_dim is per level: use heads(level)")
        return self.attention_head_dim

    @property
    def levels(self) -> int:
        return len(self.block_out_channels)

    def heads(self, level: int) -> int:
        """The spatial attention's head count at ``level`` (-1: the last, the
        mid block's)."""
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[level]

    def depth(self, level: int) -> int:
        """The transformer layers of a spatial attention at ``level``."""
        n = self.transformer_layers_per_block
        return n if isinstance(n, int) else n[level]

    @classmethod
    def from_unet_additional_kwargs(
        cls, d: Mapping[str, Any], **overrides: Any
    ) -> "UNet3DConfig":
        """Build from the YAML ``unet_additional_kwargs`` block."""
        kwargs: dict = {}
        for key in ("use_inflated_groupnorm", "use_motion_module",
                    "motion_module_mid_block", "motion_module_decoder_only",
                    "guided_recompute"):
            if key in d:
                kwargs[key] = bool(d[key])
        if "motion_module_resolutions" in d:
            kwargs["motion_module_resolutions"] = tuple(d["motion_module_resolutions"])
        if "motion_module_kwargs" in d:
            kwargs["motion_module"] = MotionModuleConfig.from_dict(d["motion_module_kwargs"])
        kwargs.update(overrides)
        return cls(**kwargs)


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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NoiseScheduleConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


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


@dataclasses.dataclass(frozen=True)
class Example:
    """One JSONL example (configs/t2v_camera.jsonl); the i2v fields
    (condition images, their frame indices, the conditioning scale) are
    read by a runtime with a controlnet (configs/i2v_rgb.jsonl)."""

    video_path: str
    new_prompt: str
    seed: Optional[int] = None
    condition_image_paths: Tuple[str, ...] = ()
    image_index: Tuple[int, ...] = (0,)
    controlnet_scale: Optional[float] = None

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Example":
        return cls(
            video_path=d["video_path"],
            new_prompt=d["new_prompt"],
            seed=d.get("seed"),
            condition_image_paths=tuple(d.get("condition_image_paths", ())),
            image_index=tuple(d.get("image_index", (0,))),
            controlnet_scale=d.get("controlnet_scale"),
        )


def load_yaml(path: str) -> dict:
    """A config YAML as a dict (an empty file gives {})."""
    return yaml_subset.load(path) or {}


# (YAML key, InferenceConfig field, cast); both spellings of the positive
# prompt, the reference's "postive_prompt" first so that the corrected key
# wins when both are present
_INFERENCE_KEYS = (
    ("motion_module", "motion_module", str),
    ("dreambooth_path", "dreambooth_path", str),
    ("model_config", "model_config", str),
    ("cfg_scale", "cfg_scale", float),
    ("negative_prompt", "negative_prompt", str),
    ("postive_prompt", "positive_prompt", str),
    ("positive_prompt", "positive_prompt", str),
    ("inference_steps", "inference_steps", int),
    ("guidance_scale", "guidance_fraction", float),
    ("guidance_steps", "guidance_steps", int),
    ("warm_up_steps", "warm_up_steps", int),
    ("cool_up_steps", "cool_up_steps", int),
    ("motion_guidance_weight", "motion_guidance_weight", float),
    ("motion_guidance_blocks", "motion_guidance_blocks", tuple),
    ("add_noise_step", "add_noise_step", int),
    ("W", "width", int),
    ("H", "height", int),
    ("L", "video_length", int),
    ("controlnet_path", "controlnet_path", str),
    ("controlnet_config", "controlnet_config", str),
    ("controlnet_scale", "controlnet_scale", float),
    ("adapter_lora_path", "adapter_lora_path", str),
    ("adapter_lora_scale", "adapter_lora_scale", float),
)


def load_inference_config(path: str, **overrides: Any) -> InferenceConfig:
    """Parse a reference-format workload YAML into an :class:`InferenceConfig`.

    ``overrides`` are fallback defaults: a key present in the YAML wins, as
    the reference's ``config.get("W", args.W)`` (its YAML size keys override
    the CLI flags)."""
    raw = load_yaml(path)
    kwargs = {field: cast(raw[key]) for key, field, cast in _INFERENCE_KEYS if key in raw}
    for k, v in overrides.items():
        kwargs.setdefault(k, v)
    cfg = InferenceConfig(**kwargs)
    cfg.validate()
    return cfg


def load_model_config(path: str) -> Tuple[UNet3DConfig, NoiseScheduleConfig]:
    """Parse a reference-format model-config YAML (model_config.yaml)."""
    raw = load_yaml(path)
    unet_cfg = UNet3DConfig.from_unet_additional_kwargs(raw.get("unet_additional_kwargs", {}))
    sched_cfg = NoiseScheduleConfig.from_dict(raw.get("noise_scheduler_kwargs", {}))
    return unet_cfg, sched_cfg


def load_examples(path: str) -> list:
    """Parse a reference-format JSONL example stream (blank lines skipped)."""
    examples = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                examples.append(Example.from_json(json.loads(line)))
    return examples


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
