"""Carry the JAX package's flax parameters into the port's modules.

Takes a flax parameter tree whose leaves are numpy arrays (``{"params":
{...}}`` or the bare tree) and returns a state dict for the port's
``UNet3DConditionModel``, ``SparseControlNetModel``, ``AutoencoderKL`` or
``CLIPTextModel``:

* flax path -> diffusers key, the inverse of ``torch_key_to_path`` in
  ``motionclone_tpu/weights/convert.py``: a segment ``name_N`` (N digits)
  is ``name.N``, except names whose digit belongs to the name
  (``linear_1``, ``mlp_fc1`` ...);
* conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
  ``scale`` and ``embedding`` -> ``weight``.

The CLIP tree is flat (``layers_N/self_attn/q_proj``); its keys get the
Hugging Face nesting (``text_model.encoder.layers.N.self_attn.q_proj``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax module names that end in _<digit> as part of the name
_NO_SPLIT = frozenset({"linear_1", "linear_2", "mlp_fc1", "mlp_fc2"})
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def flax_path_to_key(path) -> str:
    """('down_blocks_0', 'resnets_1', 'conv1', 'kernel') ->
    'down_blocks.0.resnets.1.conv1.weight'."""
    *segs, leaf = path
    out = []
    for seg in segs:
        name, _, num = seg.rpartition("_")
        if seg not in _NO_SPLIT and name and num.isdigit():
            out += [name, num]
        else:
            out.append(seg)
    return ".".join(out + [_LEAF[leaf]])


def _leaf_value(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # (in, out) -> (out, in)
    return arr


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """UNet, controlnet or VAE flax tree -> the port module's state dict
    (float32)."""
    tree = params.get("params", params)
    sd = {}
    for path, arr in _flatten(tree).items():
        value = _leaf_value(path[-1], np.asarray(arr, dtype=np.float32))
        sd[flax_path_to_key(path)] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def clip_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """CLIP text-tower flax tree -> the port's ``CLIPTextModel`` state dict."""
    sd = {}
    for key, value in state_dict_from_flax(params).items():
        if key.startswith(("token_embedding.", "position_embedding.")):
            key = "embeddings." + key
        elif key.startswith("layers."):
            key = "encoder." + key.replace("mlp_fc", "mlp.fc")
        sd["text_model." + key] = value
    return sd
