"""From checkpoint files to loaded modules.

Port of ``motionclone_tpu/weights/load.py``:

1. base SD1.5 (or SDXL) weights from a diffusers-layout directory
   (``unet``, ``vae``, ``text_encoder`` and SDXL's ``text_encoder_2``; the
   2D UNet holds no motion modules);
2. an optional DreamBooth LDM checkpoint replacing the UNet's image layers
   and the whole VAE and CLIP;
3. the motion-module checkpoint merged in (keys holding ``motion_modules.``);
4. the optional LoRAs: a kohya image LoRA into the UNet and the text
   encoder, the adapter LoRA and any number of motion LoRAs (diffusers
   naming) into the UNet;
5. :func:`load_into`: the buffers the modules compute themselves dropped
   (``pos_encoder.pe``; CLIP's ``position_ids`` and ``text_projection*``),
   a strict check of keys and shapes, then the tensors become the module's
   parameters in the requested dtype;
6. the i2v workloads' SparseCtrl checkpoint: :func:`controlnet_state_dict`,
   then :func:`load_into`.

The port's module keys are the diffusers / Hugging Face keys, so nothing is
transposed.  The ``config.json`` of each subfolder sets the topology, as
``from_pretrained`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from motionclone_tpu_torch.config import UNet3DConfig
from motionclone_tpu_torch.models.clip_text import CLIPTextConfig
from motionclone_tpu_torch.models.vae import VAEConfig
from motionclone_tpu_torch.weights.convert import (
    DEFAULT_SKIP_SUBSTRINGS,
    check_state_dict,
    merge_state_dicts,
)
from motionclone_tpu_torch.weights.io import load_state_dict
from motionclone_tpu_torch.weights.ldm import convert_ldm_clip, convert_ldm_unet, convert_ldm_vae
from motionclone_tpu_torch.weights.lora import merge_diffusers_lora, merge_kohya_lora

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# diffusers config.json
# ---------------------------------------------------------------------------


def load_diffusers_config(pretrained_dir: str, subfolder: str) -> Optional[Mapping[str, Any]]:
    """The ``config.json`` of a diffusers-layout subfolder, or None."""
    p = os.path.join(pretrained_dir, subfolder, "config.json")
    if not os.path.isfile(p):
        return None
    with open(p, "r") as f:
        return json.load(f)


# 2D -> 3D block classes (the 2D config's block names inflated)
_BLOCK_2D_TO_3D = {
    "CrossAttnDownBlock2D": "CrossAttnDownBlock3D",
    "DownBlock2D": "DownBlock3D",
    "UpBlock2D": "UpBlock3D",
    "CrossAttnUpBlock2D": "CrossAttnUpBlock3D",
}


def apply_unet_diffusers_config(unet_cfg: UNet3DConfig, pretrained_dir: str) -> UNet3DConfig:
    """Overlay ``unet/config.json``'s topology onto the model-config's
    UNet3DConfig (2D block classes inflated to 3D); unchanged when the file
    is absent."""
    d = load_diffusers_config(pretrained_dir, "unet")
    if d is None:
        return unet_cfg
    kwargs: Dict[str, Any] = {
        k: d[k] for k in ("sample_size", "in_channels", "out_channels", "layers_per_block",
                          "norm_num_groups", "cross_attention_dim", "attention_head_dim",
                          "flip_sin_to_cos", "freq_shift", "use_linear_projection",
                          "transformer_layers_per_block", "addition_embed_type",
                          "addition_time_embed_dim", "projection_class_embeddings_input_dim")
        if d.get(k) is not None
    }
    # a head count or a transformer depth per level (SDXL's lists)
    for key in ("attention_head_dim", "transformer_layers_per_block"):
        if isinstance(kwargs.get(key), list):
            kwargs[key] = tuple(kwargs[key])
    if d.get("block_out_channels"):
        kwargs["block_out_channels"] = tuple(d["block_out_channels"])
    for key in ("down_block_types", "up_block_types"):
        if d.get(key):
            kwargs[key] = tuple(_BLOCK_2D_TO_3D.get(b, b) for b in d[key])
    return dataclasses.replace(unet_cfg, **kwargs)


def vae_config_from_dir(pretrained_dir: str) -> VAEConfig:
    """``vae/config.json`` -> VAEConfig (SD1.5's VAE when absent)."""
    d = load_diffusers_config(pretrained_dir, "vae")
    if d is None:
        return VAEConfig()
    kwargs: Dict[str, Any] = {
        k: d[k] for k in ("in_channels", "out_channels", "latent_channels",
                          "layers_per_block", "norm_num_groups", "scaling_factor")
        if d.get(k) is not None
    }
    if d.get("block_out_channels"):
        kwargs["block_out_channels"] = tuple(d["block_out_channels"])
    return VAEConfig(**kwargs)


def has_second_tower(pretrained_dir: str) -> bool:
    """Whether the directory holds SDXL's second text tower."""
    return os.path.isdir(os.path.join(pretrained_dir, "text_encoder_2"))


def clip_config_from_dir(pretrained_dir: str, subfolder: str = "text_encoder",
                         penultimate: bool = False, projection: bool = False
                         ) -> CLIPTextConfig:
    """``<subfolder>/config.json`` (transformers field names) ->
    CLIPTextConfig (SD1.5's CLIP ViT-L/14 text tower when absent), giving
    the state before the last layer with ``penultimate`` and the pooled
    text's projection (``projection_dim``) with ``projection`` (SDXL)."""
    d = load_diffusers_config(pretrained_dir, subfolder)
    base = CLIPTextConfig(output_hidden_state="penultimate" if penultimate else "last")
    if d is None:
        if projection:
            raise FileNotFoundError(f"no {pretrained_dir}/{subfolder}/config.json")
        return base
    return CLIPTextConfig(
        output_hidden_state=base.output_hidden_state,
        projection_dim=d.get("projection_dim", d.get("hidden_size")) if projection else None,
        vocab_size=d.get("vocab_size", base.vocab_size),
        hidden_size=d.get("hidden_size", base.hidden_size),
        num_layers=d.get("num_hidden_layers", base.num_layers),
        num_heads=d.get("num_attention_heads", base.num_heads),
        max_position_embeddings=d.get("max_position_embeddings",
                                      base.max_position_embeddings),
        intermediate_size=d.get("intermediate_size", base.intermediate_size),
        layer_norm_eps=d.get("layer_norm_eps", base.layer_norm_eps),
        # SD2.x-style towers declare exact gelu: CLIPTextConfig refuses an
        # activation it cannot compute
        hidden_act=d.get("hidden_act", base.hidden_act),
    )


# ---------------------------------------------------------------------------
# files -> state dicts
# ---------------------------------------------------------------------------


def resolve_diffusers_module_path(pretrained_dir: str, subfolder: str) -> Optional[str]:
    """The checkpoint file of a diffusers-layout subfolder, or None."""
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        p = os.path.join(pretrained_dir, subfolder, name)
        if os.path.isfile(p):
            return p
    return None


def load_diffusers_module_sd(pretrained_dir: str, subfolder: str) -> StateDict:
    path = resolve_diffusers_module_path(pretrained_dir, subfolder)
    if path is None:
        raise FileNotFoundError(f"no checkpoint found under {pretrained_dir}/{subfolder}")
    return load_state_dict(path)


def assemble_pipeline_state_dicts(
    pretrained_dir: str,
    *,
    motion_module_path: str = "",
    dreambooth_path: str = "",
    adapter_lora_path: str = "",
    adapter_lora_scale: float = 1.0,
    lora_model_path: str = "",
    lora_alpha: float = 0.8,
    motion_lora_configs: Sequence[Tuple[str, float]] = (),
    dreambooth_extract_ema: bool = False,
) -> Dict[str, StateDict]:
    """The final flat state dicts of ``unet`` (motion modules merged),
    ``vae`` and ``text_encoder``, in float32 on the host.

    The merges run in the reference's order (util.py:115-215): a DreamBooth
    checkpoint replaces the VAE and CLIP whole and the UNet's image layers
    (its EMA weights with ``dreambooth_extract_ema``); the motion module;
    a kohya image LoRA (``lora_model_path``) into the UNet (``lora_unet``
    pairs) and the text encoder (``lora_te`` pairs) at ``lora_alpha``; the
    adapter LoRA at ``adapter_lora_scale``; then each ``(path, alpha)`` of
    ``motion_lora_configs`` in list order.  No config key reaches the last
    four arguments (as in the JAX package's runner), so the runtime never
    passes them and the weights cache's key does not name them."""
    sd_unet = load_diffusers_module_sd(pretrained_dir, "unet")
    sd_vae = load_diffusers_module_sd(pretrained_dir, "vae")
    sd_clip = load_diffusers_module_sd(pretrained_dir, "text_encoder")

    if dreambooth_path:
        db = load_state_dict(dreambooth_path)
        sd_unet_db = convert_ldm_unet(db, extract_ema=dreambooth_extract_ema)
        sd_vae_db = convert_ldm_vae(db)
        sd_clip_db = convert_ldm_clip(db)
        if sd_unet_db:
            sd_unet = merge_state_dicts(sd_unet, sd_unet_db)
        if sd_vae_db:
            sd_vae = sd_vae_db
        if sd_clip_db:
            sd_clip = sd_clip_db

    if motion_module_path:
        mm = load_state_dict(motion_module_path)
        sd_unet = merge_state_dicts(sd_unet, mm, filter_substring="motion_modules.")

    if lora_model_path:
        lora = load_state_dict(lora_model_path)
        sd_unet = merge_kohya_lora(sd_unet, lora, alpha=lora_alpha, prefix="lora_unet")
        sd_clip = merge_kohya_lora(sd_clip, lora, alpha=lora_alpha, prefix="lora_te")

    if adapter_lora_path:
        lora = load_state_dict(adapter_lora_path)
        sd_unet = merge_diffusers_lora(sd_unet, lora, alpha=adapter_lora_scale)

    for path, alpha in motion_lora_configs:
        sd_unet = merge_diffusers_lora(sd_unet, load_state_dict(path), alpha=alpha)

    return {"unet": sd_unet, "vae": sd_vae, "text_encoder": sd_clip}


# ---------------------------------------------------------------------------
# state dicts -> modules
# ---------------------------------------------------------------------------


def clip_state_dict(sd: Mapping[str, torch.Tensor], projection: bool = False) -> StateDict:
    """An HF CLIPTextModel state dict with the ``text_model.`` prefix on
    every key (some checkpoints omit it), ``position_ids`` dropped, and
    ``text_projection*`` dropped, or with ``projection`` (SDXL's
    CLIPTextModelWithProjection) kept as ``text_projection.weight``."""
    out: StateDict = {}
    for k, v in sd.items():
        key = k[len("text_model."):] if k.startswith("text_model.") else k
        if key.endswith("position_ids"):
            continue
        if key.startswith("text_projection"):
            if projection:
                out[key] = v
            continue
        out["text_model." + key] = v
    return out


def controlnet_state_dict(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A SparseCtrl checkpoint's state dict for ``SparseControlNetModel``:
    the ``pos_encoder.pe`` buffers (the model computes its own table) and
    the ``animatediff_config`` entry dropped; :func:`load_into` then checks
    the keys and shapes strictly."""
    return {k: v for k, v in sd.items()
            if "pos_encoder.pe" not in k and k != "animatediff_config"}


def assemble_state_dicts(
    pretrained_dir: str,
    *,
    motion_module_path: str = "",
    dreambooth_path: str = "",
    adapter_lora_path: str = "",
    adapter_lora_scale: float = 1.0,
    controlnet_path: str = "",
    lora_model_path: str = "",
    lora_alpha: float = 0.8,
    motion_lora_configs: Sequence[Tuple[str, float]] = (),
    dreambooth_extract_ema: bool = False,
) -> Dict[str, StateDict]:
    """The state dict of each module as :func:`load_into` takes it (what
    the weights cache stores): :func:`assemble_pipeline_state_dicts`'s
    (the merge arguments passed on), CLIP's through
    :func:`clip_state_dict` and, with a ``controlnet_path``, the
    controlnet's through :func:`controlnet_state_dict`."""
    sds = assemble_pipeline_state_dicts(
        pretrained_dir, motion_module_path=motion_module_path,
        dreambooth_path=dreambooth_path, adapter_lora_path=adapter_lora_path,
        adapter_lora_scale=adapter_lora_scale, lora_model_path=lora_model_path,
        lora_alpha=lora_alpha, motion_lora_configs=motion_lora_configs,
        dreambooth_extract_ema=dreambooth_extract_ema)
    sds["text_encoder"] = clip_state_dict(sds["text_encoder"])
    if has_second_tower(pretrained_dir):
        sds["text_encoder_2"] = clip_state_dict(
            load_diffusers_module_sd(pretrained_dir, "text_encoder_2"), projection=True)
    if controlnet_path:
        sds["controlnet"] = controlnet_state_dict(load_state_dict(controlnet_path))
    return sds


@contextlib.contextmanager
def _initialisers_off():
    """``torch.nn.init``'s in-place initialisers as no-ops: on the meta
    device ``normal_`` (every ``nn.Embedding``'s) has no C++ kernel, and its
    first call in a process imports torch's Python meta kernels, 2-9 s on
    the CPUs measured, for values that the load overwrites."""
    init = torch.nn.init
    saved = {n: getattr(init, n) for n in dir(init) if n.endswith("_") and not n.startswith("_")}
    for n in saved:
        setattr(init, n, lambda tensor, *args, **kwargs: tensor)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(init, n, fn)


def load_into(module_fn: Callable[[], torch.nn.Module], sd: Mapping[str, torch.Tensor],
              dtype: torch.dtype, what: str = "checkpoint") -> torch.nn.Module:
    """The module ``module_fn()`` builds, with ``sd``'s tensors (cast to
    ``dtype``) as its parameters.  The module is built on the meta device
    with the initialisers off, so no time or memory is spent on values that
    the load overwrites; keys holding ``pos_encoder.pe`` are dropped, then
    the keys and shapes must match exactly (``ValueError`` otherwise)."""
    sd = {k: v for k, v in sd.items() if not any(s in k for s in DEFAULT_SKIP_SUBSTRINGS)}
    with torch.device("meta"), _initialisers_off():
        module = module_fn()
    check_state_dict(sd, module, what)
    module.load_state_dict({k: v.to(dtype) for k, v in sd.items()}, strict=True, assign=True)
    return module.eval()
