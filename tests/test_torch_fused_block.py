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
* the port's copy of the routing predicate against JAX's;
* without JAX: the products' shape rule, the kernels' own predicate
  (``device_supported``) at SD1.5 width and at the widths the JAX package
  fuses but the product does not take (C = 80, 240), and the route a model
  takes on CUDA (the unfused one there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.models import attention as jattn
from motionclone_tpu.ops import fused_block as jfb
from motionclone_tpu_torch.models import attention as tattn
from motionclone_tpu_torch.ops import fused_block as tfb
from test_torch_models import close, load_port, one_torch_thread, random_flax_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


# ---------------------------------------------------------------------------
# the shapes of the TMA + wgmma product (csrc/fused_product.cuh), no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2])  # a CFG half, the vanilla pair
@pytest.mark.parametrize("level", range(4))  # 64², 32², 16², 8² latents at 512²
def test_main_path_products_fit_the_product(level, b):
    """Every product kernels 5 and 6 launch at UNet3DConfig() widths is a
    shape the wgmma product takes; the levels the predicate leaves unfused
    launch none."""
    from motionclone_tpu_torch.config import UNet3DConfig
    from motionclone_tpu_torch.ops import fused_common as fc

    cfg = UNet3DConfig()
    s, c = (64 >> level) ** 2, cfg.block_out_channels[level]
    if not tfb.supported(s, c, cfg.num_heads):
        assert c > tfb.MAX_FUSED_CHANNELS
        return
    for whole in (True, False):
        prods = tfb.products(16 * b, s, c, b, 77, cfg.cross_attention_dim, whole)
        assert len(prods) == (9 if whole else 7)
        fc.check_products("fused_spatial_transformer", prods)


@pytest.mark.parametrize("prod", [
    dict(m=256, n=320, k=32),             # K not a multiple of 64
    dict(m=256, n=128, k=64),             # N not a multiple of 160
    dict(m=256, n=480, k=64, split=240),  # a q|k|v chunk straddling tiles
    dict(m=0, n=320, k=320),
])
def test_product_shape_rule_refuses(prod):
    from motionclone_tpu_torch.ops import fused_common as fc

    with pytest.raises(ValueError, match="TMA \\+ wgmma product"):
        fc.check_product("test", fc.Product("x", **prod))


@pytest.mark.parametrize("entry", ["block", "transformer"])
def test_kernel_wrappers_refuse_unsupported_shapes_before_launch(entry):
    """C = 32 (the CPU tests' width) has K % 64 != 0: the kernel wrappers
    raise ValueError before they build or launch anything."""
    bf16 = torch.bfloat16
    mat = lambda o, i: torch.zeros(o, i, dtype=bf16)
    vec = lambda n: torch.zeros(n)
    blk = tfb.BlockWeights(vec(C), vec(C), mat(3 * C, C), mat(C, C), vec(C), vec(C), vec(C),
                           mat(C, C), mat(2 * C, CTX_DIM), mat(C, C), vec(C), vec(C), vec(C),
                           mat(8 * C, C), vec(8 * C), mat(C, 4 * C), vec(C))
    x, ctx = torch.zeros(FRAMES, HH * WW, C, dtype=bf16), torch.zeros(1, T, CTX_DIM, dtype=bf16)
    with pytest.raises(ValueError, match="TMA \\+ wgmma product"):
        if entry == "block":
            tfb.fused_transformer_block_kernel(x, ctx, blk, heads=HEADS, frames=FRAMES)
        else:
            w = tfb.TransformerWeights(vec(C), vec(C), mat(C, C), vec(C), blk, mat(C, C), vec(C))
            tfb.fused_spatial_transformer_kernel(x, ctx, w, heads=HEADS, groups=GROUPS,
                                                 frames=FRAMES)


@pytest.mark.parametrize("epilogue", ["bias", "res_bf16", "res_f32_inplace", "geglu", "split"])
def test_product_plain_version(epilogue):
    """The product alone on the CPU (its plain version) against the same
    math written out: f32, one rounding at the store."""
    from motionclone_tpu_torch.ops import fused_common as fc

    r = np.random.default_rng(3)
    m, n, k = 24, 320, 64
    a = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(r.standard_normal((n, k)).astype(np.float32) / 8).to(torch.bfloat16)
    bias = torch.from_numpy(r.standard_normal(n).astype(np.float32))
    y = a.float() @ w.float().T + bias
    if epilogue == "bias":
        got, want = fc.fused_product(a, w, bias), y.to(torch.bfloat16)
    elif epilogue == "res_bf16":
        res = torch.from_numpy(r.standard_normal((m, n)).astype(np.float32)).to(torch.bfloat16)
        got, want = fc.fused_product(a, w, bias, res), (y + res.float()).to(torch.bfloat16)
    elif epilogue == "res_f32_inplace":
        h = torch.from_numpy(r.standard_normal((m, n)).astype(np.float32))
        want = y + h
        got = fc.fused_product(a, w, bias, h, out_dtype=torch.float32, out=h)
        assert got is h
    elif epilogue == "geglu":
        got = fc.fused_product(a, w, bias, geglu_out=True)
        want = (y[:, 0::2] * torch.nn.functional.gelu(y[:, 1::2])).to(torch.bfloat16)
    else:
        got = fc.fused_product(a, w, split=160)
        want = (a.float() @ w.float().T).to(torch.bfloat16).reshape(m, 2, 160).transpose(0, 1)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' own shape rule and the route on CUDA, no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,c", [(4096, 320), (1024, 640)])  # the levels that fuse
def test_device_predicate_holds_at_sd15_levels(s, c):
    assert tfb.supported(s, c, 8) and tfb.device_supported(s, c, 77, 768)


@pytest.mark.parametrize("s,c,heads", [(128, 80, 2), (256, 80, 2), (128, 240, 3),
                                       (1024, 240, 6)])
def test_narrow_widths_pass_jax_predicate_fail_device_predicate(s, c, heads):
    """C = 80 (2 heads of 40) and C = 240: the JAX package fuses them, the
    TMA + wgmma product does not take them (K % 64, N % 160)."""
    assert tfb.supported(s, c, heads)
    assert not tfb.device_supported(s, c, 77, 768)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("c,heads,cpu,cuda", [
    (80, 2, True, False), (240, 3, True, False), (C, HEADS, True, False),
    (320, 8, True, True),
])
def test_model_route_on_shapes(c, heads, cpu, cuda, linear):
    """The route a Transformer3DModel takes with impl="fused", from the
    shapes alone (the model lives on the meta device): on the CPU the plain
    version wherever the JAX package fuses; on CUDA a C = 80 or 240 model
    (and the CPU tests' C = 32) takes the unfused path instead of a kernel
    that would raise, and SD1.5's C = 320 its kernel as before."""
    with torch.device("meta"):
        m = tattn.Transformer3DModel(c, heads, c // heads, cross_attention_dim=768,
                                     norm_num_groups=8, use_linear_projection=linear)
    kernel = "transformer_block" if linear else "spatial_transformer"
    x_shape, ctx_shape = (1, FRAMES, 16, 16, c), (1, 77, 768)
    assert m.fused_route(x_shape, ctx_shape, "cpu") == (kernel if cpu else None)
    assert m.fused_route(x_shape, ctx_shape, "cuda") == (kernel if cuda else None)
    assert m.fused_route(x_shape, None, "cpu") is None
