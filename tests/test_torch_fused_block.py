"""Port kernels 5 and 6 (fused spatial transformer, transformer block)
against the JAX package, on the CPU.

* the port's plain versions (``ops/fused_block``, on the modules' own
  weights in the kernels' layout) against the JAX kernel functions
  ``fused_spatial_transformer`` and ``fused_transformer_block`` in Pallas
  interpret mode, at the sizes of tests/test_fused_block.py, f32, atol 1e-4.
  The JAX functions take the text context repeated per frame; the port's
  take it once per video with the frame count;
* the port's Transformer3DModel with ``impl="fused"`` (1x1-conv
  projections: kernel 5; linear projections: kernel 6 inside the unfused
  GN / proj_in / proj_out) against the JAX module with
  ``attention_impl="fused"`` and ``"xla"``, checking the route taken;
* the port's copy of the routing predicate against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.models import attention as jattn
from motionclone_tpu.ops import fused_block as jfb
from motionclone_tpu_torch.models import attention as tattn
from motionclone_tpu_torch.ops import fused_block as tfb
from test_torch_models import close, load_port, random_flax_params

FRAMES, HH, WW, C, HEADS = 2, 8, 16, 32, 4  # S = 128, as the JAX tests
T, CTX_DIM, GROUPS = 7, 24, 8


def _jax_block_weights(blk):
    """The JAX module's fused-route block weights (models/attention.py)."""
    return jfb.BlockWeights(
        ln1_scale=blk["norm1"]["scale"], ln1_bias=blk["norm1"]["bias"],
        wq1=blk["attn1"]["to_q"]["kernel"], wk1=blk["attn1"]["to_k"]["kernel"],
        wv1=blk["attn1"]["to_v"]["kernel"], wo1=blk["attn1"]["to_out_0"]["kernel"],
        bo1=blk["attn1"]["to_out_0"]["bias"],
        ln2_scale=blk["norm2"]["scale"], ln2_bias=blk["norm2"]["bias"],
        wq2=blk["attn2"]["to_q"]["kernel"], wk2=blk["attn2"]["to_k"]["kernel"],
        wv2=blk["attn2"]["to_v"]["kernel"], wo2=blk["attn2"]["to_out_0"]["kernel"],
        bo2=blk["attn2"]["to_out_0"]["bias"],
        ln3_scale=blk["norm3"]["scale"], ln3_bias=blk["norm3"]["bias"],
        wff1=blk["ff"]["net_0"]["proj"]["kernel"], bff1=blk["ff"]["net_0"]["proj"]["bias"],
        wff2=blk["ff"]["net_2"]["kernel"], bff2=blk["ff"]["net_2"]["bias"],
    )


def _jax_module(linear, impl):
    return jattn.Transformer3DModel(
        heads=HEADS, dim_head=C // HEADS, cross_attention_dim=CTX_DIM,
        norm_num_groups=GROUPS, use_linear_projection=linear, attention_impl=impl)


@pytest.fixture(scope="module", params=["conv", "linear"])
def case(request):
    linear = request.param == "linear"
    r = np.random.default_rng(0)
    x = r.standard_normal((1, FRAMES, HH, WW, C)).astype(np.float32)
    ctx = r.standard_normal((1, T, CTX_DIM)).astype(np.float32)
    params = random_flax_params(_jax_module(linear, "xla"), x, ctx, seed=1)
    tm = load_port(tattn.Transformer3DModel(
        C, HEADS, C // HEADS, cross_attention_dim=CTX_DIM, norm_num_groups=GROUPS,
        use_linear_projection=linear), params)
    return dict(linear=linear, x=x, ctx=ctx, params=params, tm=tm)


def test_plain_matches_jax_kernel(case):
    """Kernel 5 on the conv-projection model, kernel 6 on the block of the
    linear-projection one."""
    p = case["params"]["params"]
    x2 = case["x"].reshape(FRAMES, HH * WW, C)
    ctx_rep = jnp.repeat(jnp.asarray(case["ctx"]), FRAMES, axis=0)
    x_t, ctx_t = torch.from_numpy(x2), torch.from_numpy(case["ctx"])
    tm = case["tm"]
    if case["linear"]:
        want = jfb.fused_transformer_block(
            jnp.asarray(x2), ctx_rep, _jax_block_weights(p["transformer_blocks_0"]),
            heads=HEADS)
        got = tfb.fused_transformer_block_plain(
            x_t, ctx_t, tm.transformer_blocks[0].fused_weights(torch.float32),
            heads=HEADS, frames=FRAMES)
    else:
        w = jfb.TransformerWeights(
            gn_scale=p["norm"]["scale"], gn_bias=p["norm"]["bias"],
            win=p["proj_in"]["kernel"].reshape(C, C), bin=p["proj_in"]["bias"],
            block=_jax_block_weights(p["transformer_blocks_0"]),
            wout=p["proj_out"]["kernel"].reshape(C, C), bout=p["proj_out"]["bias"],
        )
        want = jfb.fused_spatial_transformer(jnp.asarray(x2), ctx_rep, w, heads=HEADS,
                                             groups=GROUPS)
        got = tfb.fused_spatial_transformer_plain(
            x_t, ctx_t, tm.fused_weights(torch.float32), heads=HEADS, groups=GROUPS,
            frames=FRAMES)
    close(got, want)


@pytest.mark.parametrize("jax_impl", ["fused", "xla"])
def test_module_fused_matches_jax(case, jax_impl, monkeypatch):
    calls = {}
    for name in ("fused_spatial_transformer_plain", "fused_transformer_block_plain"):
        fn = getattr(tfb, name)
        monkeypatch.setattr(tfb, name, lambda *a, _n=name, _f=fn, **k:
                            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a, **k))
    want = _jax_module(case["linear"], jax_impl).apply(case["params"], case["x"], case["ctx"])
    with torch.no_grad():
        got = case["tm"](torch.from_numpy(case["x"]), torch.from_numpy(case["ctx"]), "fused")
    close(got, want)
    # the whole model fuses with 1x1-conv projections (kernel 5), only its
    # block with linear ones (kernel 6), as in the JAX package
    if case["linear"]:
        assert calls == {"fused_transformer_block_plain": 1}
    else:
        assert calls.get("fused_spatial_transformer_plain") == 1


@pytest.mark.parametrize("s,c,heads", [
    # main path: 64x64 and 32x32 levels fuse, 16x16 and 8x8 (1280) do not
    (4096, 320, 8), (1024, 640, 8), (256, 1280, 8), (64, 1280, 8),
    # the JAX tests' edge cases
    (4095, 320, 8), (4096, 1280, 8), (128, 32, 4), (128, 30, 3), (128, 32, 8),
    (1536, 320, 8),
])
def test_predicate_matches_jax(s, c, heads):
    assert tfb.supported(s, c, heads) == jfb.supported(s, c, heads)
