"""LDM (CompVis) checkpoint -> diffusers key remapping.

Port of ``motionclone_tpu/weights/ldm.py``.  DreamBooth community
checkpoints (configs/t2v_camera.yaml's ``dreambooth_path``) ship in the
original LDM layout; these functions remap them to the diffusers / Hugging
Face keys of the port's modules, driven by the key set's structure instead
of fixed index tables, so small topologies map too.  Pure key remaps (the
VAE attention's 1x1 convolutions become linear weights by a reshape).

All functions take and return flat {key: tensor} dicts.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]

_RESNET_MAP = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}

_VAE_RESNET_MAP = {
    "norm1": "norm1",
    "conv1": "conv1",
    "norm2": "norm2",
    "conv2": "conv2",
    "nin_shortcut": "conv_shortcut",
}

_VAE_ATTN_MAP = {
    "norm": "group_norm",
    "q": "to_q",
    "k": "to_k",
    "v": "to_v",
    "proj_out": "to_out.0",
}


def _sub_keys(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _map_block(src: Mapping[str, torch.Tensor], mapping: Mapping[str, str],
               src_prefix: str, dst_prefix: str, out: StateDict) -> None:
    for src_name, dst_name in mapping.items():
        for leaf in ("weight", "bias"):
            k = f"{src_prefix}{src_name}.{leaf}"
            if k in src:
                out[f"{dst_prefix}{dst_name}.{leaf}"] = src[k]


def _copy_prefix(src: Mapping[str, torch.Tensor], src_prefix: str,
                 dst_prefix: str, out: StateDict) -> None:
    for k, v in src.items():
        if k.startswith(src_prefix):
            out[dst_prefix + k[len(src_prefix):]] = v


def convert_ldm_unet(sd: Mapping[str, torch.Tensor], *, extract_ema: bool = False) -> StateDict:
    """model.diffusion_model.* -> diffusers UNet2D keys.

    Handles the SD1.x layout: 4 down blocks x ``layers_per_block`` layers with
    optional spatial transformers, mid block, 4 up blocks x (layers+1).
    Block/layer counts are inferred from the key set.

    ``extract_ema``: when the checkpoint carries >100 ``model_ema.*`` keys,
    each UNet weight is taken from its EMA shadow, whose key is the
    dot-stripped flattening ``model_ema.<segments after the first, joined
    without dots>``.  The reference's ``load_weights`` never sets it, so the
    default takes the non-EMA weights.  Both mismatches warn (the flag with
    no EMA present, EMA present without the flag): no silent fallback.
    """
    has_ema = sum(k.startswith("model_ema.") for k in sd) > 100
    if extract_ema and has_ema:
        src: StateDict = {}
        for k in sd:
            if k.startswith("model.diffusion_model."):
                flat_ema = "model_ema." + "".join(k.split(".")[1:])
                src[k[len("model.diffusion_model."):]] = sd[flat_ema]
    else:
        import warnings

        if extract_ema:
            warnings.warn(
                "extract_ema requested but the checkpoint carries no EMA "
                "weights (<=100 model_ema.* keys) — extracting the non-EMA "
                "weights instead",
                stacklevel=2,
            )
        elif has_ema:
            warnings.warn(
                "checkpoint has both EMA and non-EMA weights; extracting "
                "the non-EMA weights (pass extract_ema=True for the EMA "
                "set, usually better for inference)",
                stacklevel=2,
            )
        src = _sub_keys(sd, "model.diffusion_model.")
    out: StateDict = {}

    out["time_embedding.linear_1.weight"] = src["time_embed.0.weight"]
    out["time_embedding.linear_1.bias"] = src["time_embed.0.bias"]
    out["time_embedding.linear_2.weight"] = src["time_embed.2.weight"]
    out["time_embedding.linear_2.bias"] = src["time_embed.2.bias"]
    out["conv_in.weight"] = src["input_blocks.0.0.weight"]
    out["conv_in.bias"] = src["input_blocks.0.0.bias"]
    out["conv_norm_out.weight"] = src["out.0.weight"]
    out["conv_norm_out.bias"] = src["out.0.bias"]
    out["conv_out.weight"] = src["out.2.weight"]
    out["conv_out.bias"] = src["out.2.bias"]

    n_input = 1 + max(
        int(k.split(".")[1]) for k in src if k.startswith("input_blocks.")
    )
    # layers per block: number of consecutive non-downsample input blocks
    # before the first downsample ('op' submodule marks a downsampler)
    downsample_ids = sorted(
        {
            int(k.split(".")[1])
            for k in src
            if k.startswith("input_blocks.") and ".op." in k
        }
    )
    layers = (downsample_ids[0] - 1) if downsample_ids else (n_input - 1)

    for i in range(1, n_input):
        block_id = (i - 1) // (layers + 1)
        layer_id = (i - 1) % (layers + 1)
        pre = f"input_blocks.{i}."
        if f"{pre}0.op.weight" in src:
            out[f"down_blocks.{block_id}.downsamplers.0.conv.weight"] = src[
                f"{pre}0.op.weight"
            ]
            out[f"down_blocks.{block_id}.downsamplers.0.conv.bias"] = src[
                f"{pre}0.op.bias"
            ]
            continue
        _map_block(
            src, _RESNET_MAP, f"{pre}0.",
            f"down_blocks.{block_id}.resnets.{layer_id}.", out,
        )
        if f"{pre}1.norm.weight" in src:
            _copy_prefix(
                src, f"{pre}1.",
                f"down_blocks.{block_id}.attentions.{layer_id}.", out,
            )

    _map_block(src, _RESNET_MAP, "middle_block.0.", "mid_block.resnets.0.", out)
    _copy_prefix(src, "middle_block.1.", "mid_block.attentions.0.", out)
    _map_block(src, _RESNET_MAP, "middle_block.2.", "mid_block.resnets.1.", out)

    n_output = 1 + max(
        int(k.split(".")[1]) for k in src if k.startswith("output_blocks.")
    )
    for i in range(n_output):
        block_id = i // (layers + 1)
        layer_id = i % (layers + 1)
        pre = f"output_blocks.{i}."
        _map_block(
            src, _RESNET_MAP, f"{pre}0.",
            f"up_blocks.{block_id}.resnets.{layer_id}.", out,
        )
        # module 1 is an attention if it has a transformer norm, else an
        # upsampler conv; module 2 (if present) is always the upsampler
        if f"{pre}1.norm.weight" in src:
            _copy_prefix(
                src, f"{pre}1.",
                f"up_blocks.{block_id}.attentions.{layer_id}.", out,
            )
            up_mod = f"{pre}2.conv."
        else:
            up_mod = f"{pre}1.conv."
        if f"{up_mod}weight" in src:
            out[f"up_blocks.{block_id}.upsamplers.0.conv.weight"] = src[
                f"{up_mod}weight"
            ]
            out[f"up_blocks.{block_id}.upsamplers.0.conv.bias"] = src[f"{up_mod}bias"]
    return out


def _convert_vae_attention(src: Mapping[str, torch.Tensor], src_prefix: str,
                           dst_prefix: str, out: StateDict) -> None:
    for src_name, dst_name in _VAE_ATTN_MAP.items():
        for leaf in ("weight", "bias"):
            k = f"{src_prefix}{src_name}.{leaf}"
            if k not in src:
                continue
            v = src[k]
            if dst_name != "group_norm" and leaf == "weight" and v.ndim == 4:
                v = v.reshape(v.shape[0], v.shape[1])  # 1x1 conv -> dense
            out[f"{dst_prefix}{dst_name}.{leaf}"] = v


def convert_ldm_vae(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """first_stage_model.* -> diffusers AutoencoderKL keys."""
    src = _sub_keys(sd, "first_stage_model.")
    out: StateDict = {}

    for coder in ("encoder", "decoder"):
        _copy_prefix(src, f"{coder}.conv_in.", f"{coder}.conv_in.", out)
        _copy_prefix(src, f"{coder}.conv_out.", f"{coder}.conv_out.", out)
        _copy_prefix(src, f"{coder}.norm_out.", f"{coder}.conv_norm_out.", out)
        _map_block(
            src, _VAE_RESNET_MAP, f"{coder}.mid.block_1.",
            f"{coder}.mid_block.resnets.0.", out,
        )
        _map_block(
            src, _VAE_RESNET_MAP, f"{coder}.mid.block_2.",
            f"{coder}.mid_block.resnets.1.", out,
        )
        _convert_vae_attention(
            src, f"{coder}.mid.attn_1.", f"{coder}.mid_block.attentions.0.", out
        )
    _copy_prefix(src, "quant_conv.", "quant_conv.", out)
    _copy_prefix(src, "post_quant_conv.", "post_quant_conv.", out)

    down_ids = sorted(
        {int(k.split(".")[2]) for k in src if k.startswith("encoder.down.")}
    )
    for i in down_ids:
        block_ids = sorted(
            {
                int(k.split(".")[4])
                for k in src
                if k.startswith(f"encoder.down.{i}.block.")
            }
        )
        for j in block_ids:
            _map_block(
                src, _VAE_RESNET_MAP, f"encoder.down.{i}.block.{j}.",
                f"encoder.down_blocks.{i}.resnets.{j}.", out,
            )
        _copy_prefix(
            src, f"encoder.down.{i}.downsample.conv.",
            f"encoder.down_blocks.{i}.downsamplers.0.conv.", out,
        )

    up_ids = sorted(
        {int(k.split(".")[2]) for k in src if k.startswith("decoder.up.")}
    )
    n_up = len(up_ids)
    for i in up_ids:
        dst_i = n_up - 1 - i  # LDM decoder indexes bottom-up; diffusers top-down
        block_ids = sorted(
            {
                int(k.split(".")[4])
                for k in src
                if k.startswith(f"decoder.up.{i}.block.")
            }
        )
        for j in block_ids:
            _map_block(
                src, _VAE_RESNET_MAP, f"decoder.up.{i}.block.{j}.",
                f"decoder.up_blocks.{dst_i}.resnets.{j}.", out,
            )
        _copy_prefix(
            src, f"decoder.up.{i}.upsample.conv.",
            f"decoder.up_blocks.{dst_i}.upsamplers.0.conv.", out,
        )
    return out


def convert_ldm_clip(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """cond_stage_model.transformer.* -> HF CLIPTextModel keys
    (reference convert_ldm_clip_checkpoint_concise, convert_from_ckpt.py:716)."""
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith("cond_stage_model.transformer."):
            continue
        key = k[len("cond_stage_model.transformer."):]
        if not key.startswith("text_model."):
            key = "text_model." + key
        if key.endswith("position_ids"):
            continue
        out[key] = v
    return out
