"""A miniature cell for the CPU tests: the configurations' topology at
tiny widths (4 UNet and 4 VAE levels, so latents are an eighth of the
pixels) and the traffic mixes' schedule cut short, read from the files
and changed only where the size forces it."""

from __future__ import annotations

import copy
import json
import os

from bench_h100 import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def tiny_config(name: str) -> dict:
    c = copy.deepcopy(_read("configs", f"{name}.json"))
    mm = dict(num_attention_heads=2, norm_num_groups=4)
    c["unet"].update(block_out_channels=[8, 16, 16, 16], layers_per_block=1, norm_num_groups=4,
                     cross_attention_dim=16, attention_head_dim=2)
    c["unet"]["motion_module"].update(mm)
    c["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
    c["text_encoder"].update(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                             intermediate_size=32)
    if c.get("controlnet"):
        c["controlnet"].update(block_out_channels=[8, 16, 16, 16], layers_per_block=1,
                               norm_num_groups=4, cross_attention_dim=16, num_heads=2)
        c["controlnet"]["motion_module"].update(mm)
    return c


def tiny_traffic(name: str, batch: int = None) -> dict:
    t = copy.deepcopy(_read("traffic", f"{name}.json"))
    t["schedule"].update(inference_steps=6, guidance_steps=3, warm_up_steps=1, cool_up_steps=1)
    t["video"].update(width=64, height=64, frames=4)
    t["loop"]["max_jobs"] = 2
    t["check"].update(guided_steps=1, vanilla_steps=1)
    if batch is not None:
        t["batch"] = batch
    return t


def tiny_cell(cell: str, limits=None, batch=None) -> harness.Cell:
    real = harness.load_cell(cell)
    conf = {"t2v_camera.b2": ("sd15-ad3-t2v", "t2v_camera.b2"),
            "i2v_rgb.b1": ("sd15-ad3-sparsectrl-rgb", "i2v_rgb.b1")}[cell]
    return harness.Cell(cell, tiny_config(conf[0]), tiny_traffic(conf[1], batch),
                        real.limits if limits is None else limits, real.end_to_end,
                        real.per_layer)
