"""The yardstick's counts against hand counts at small shapes: each
kernel's operations and bytes (``work/bounds.py``) and the model FLOPs
that ``work/flops.py`` takes from the plain reference."""

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.reference import nets
from bench_h100.tests.tiny import tiny_cell
from bench_h100.work import bounds
from bench_h100.work.flops import job_flops


def t(*shape):
    return SimpleNamespace(shape=shape)


@pytest.mark.parametrize("name, args, kwargs, flops, nbytes", [
    # q (B=2, Sq=4, 2 heads x D=8), k/v Sk=6: 2 products of 2*Sq*Sk*16 per row
    (("flash_attention", "flash_fwd"), (t(2, 4, 16), t(2, 6, 16), t(2, 6, 16), 2, 0.3), {},
     2 * 2 * (2 * 4 * 6 * 16), (2 * 4 * 16 * 2 + 2 * 6 * 16 * 2) * 2 + 2 * 2 * 4 * 4),
    # backward: 5 products; q, out, dout, dq (Sq rows) and k, v, dk, dv (Sk rows), lse
    (("flash_attention", "flash_bwd"), (t(2, 4, 16), t(2, 6, 16), t(2, 6, 16), None, None, None,
                                        2, 0.3), {},
     5 * 2 * (2 * 4 * 6 * 16), (4 * 2 * 4 * 16 + 4 * 2 * 6 * 16) * 2 + 2 * 2 * 4 * 4),
    # temporal: q (B=1, Fq=3, S=5, 2 heads x 4), k/v Fk=4
    (("temporal_attention", "temporal_fwd_rect"), (t(1, 3, 5, 8), t(1, 4, 5, 8), None, 2, 0.5),
     {}, 2 * 2 * (5 * 3 * 4 * 8), (2 * 3 * 5 * 8 + 2 * 4 * 5 * 8) * 2 + 5 * 2 * 3 * 4),
    (("temporal_attention", "temporal_bwd"), (t(1, 4, 5, 8), t(1, 4, 5, 8), None, None, None,
                                              2, 0.5),
     {}, 5 * 2 * (5 * 4 * 4 * 8), (3 * 4 * 5 * 8 + 4 * 4 * 5 * 8) * 2 + 5 * 2 * 4 * 4),
    # kernel 8: 2 frames of 3x3 pixels, 4 -> 6 channels: two 3x3 convs and the shortcut
    (("fused_resnet", "fused_resnet_kernel"),
     (t(1, 2, 3, 3, 4), None, SimpleNamespace(w1=t(6, 36))), {},
     2 * 18 * (9 * 4 * 6 + 9 * 6 * 6 + 4 * 6),
     2 * 18 * (4 + 6) + 2 * (9 * 4 * 6 + 9 * 6 * 6 + 4 * 6) + 2 * 6),
    # kernel 7, two attention blocks: 22 C x C products a row, 2 attentions over F frames
    (("fused_temporal", "fused_temporal_kernel"),
     (t(1, 4, 5, 8), SimpleNamespace(attn=(0, 0))), {},
     2 * 22 * (4 * 5) * 64 + 2 * (2 * 2 * 5 * 4 * 4 * 8), 2 * 2 * 20 * 8 + 2 * 22 * 64),
    # kernel 5: 20 C x C products a row, self-attention over S, cross over T, text k/v
    (("fused_block", "fused_spatial_transformer_kernel"), (t(4, 9, 8), t(2, 3, 5), None), {},
     2 * 20 * 36 * 64 + 2 * 2 * 4 * 9 * 9 * 8 + 2 * 2 * 4 * 9 * 3 * 8 + 2 * 2 * 2 * 3 * 5 * 8,
     2 * 2 * 36 * 8 + 2 * 2 * 3 * 5 + 2 * (20 * 64 + 2 * 5 * 8)),
])
def test_kernel_counts_match_hand_counts(name, args, kwargs, flops, nbytes):
    _, count = bounds.KERNELS[name]
    assert count(*args, **kwargs) == (flops, nbytes)


def test_the_bound_is_the_slower_of_operations_and_bytes():
    assert bounds.bound_s(989e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_the_flop_counter_counts_a_reference_attention_layer_by_hand():
    with torch.device("meta"):
        layer = nets.CrossAttention(16, 2, context_dim=12)
    x, ctx = torch.empty(3, 10, 16, device="meta"), torch.empty(3, 7, 12, device="meta")
    with FlopCounterMode(display=False) as counter:
        layer(x, ctx)
    projections = 2 * 3 * (10 * 16 * 16 + 2 * 7 * 12 * 16 + 10 * 16 * 16)
    products = 2 * 2 * 3 * 10 * 7 * 16
    assert counter.get_total_flops() == projections + products


def test_a_job_is_its_stages_and_steps():
    c = tiny_cell("i2v_rgb.b1")
    f = job_flops(c.config, c.traffic, c.family.networks(c.config))
    s = c.traffic["schedule"]
    g, n = s["guidance_steps"], s["inference_steps"]
    assert f["job"] == (f["text"] + f["vae_encode"] + f["condition_encode"] + f["extract"]
                        + g * f["guided_step"] + (n - g) * f["vanilla_step"] + f["vae_decode"])
    # the guided step's backward costs more than the CFG pair's second forward
    assert f["guided_step"] > f["vanilla_step"] > 0
