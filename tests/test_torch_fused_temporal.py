"""Port kernel 7 (fused motion module) against the JAX package, on the CPU.

* the port's plain version (``ops/fused_temporal.fused_temporal_module_plain``,
  on the module's own weights in the kernel's layout, GroupNorm statistics
  included) against JAX's ``folded_groupnorm_affine`` + the kernel function
  ``fused_temporal_module`` in Pallas interpret mode, at the sizes of
  tests/test_fused_temporal.py, f32, atol 1e-4, with two attention blocks
  (the UNet's motion modules) and with one (the SparseCtrl controlnet's);
* the port's module with ``impl="fused"`` against the JAX module with
  ``attention_impl="fused"`` and ``"xla"``, checking that the fused route
  was taken, and that requested probabilities keep the unfused route;
* the port's copy of the routing predicate against JAX's;
* without JAX: the products' shape rule, the kernel's own predicate
  (``device_supported``) at SD1.5 width and at the widths the JAX package
  fuses but the product does not take (C = 80, 240), and the route a motion
  module takes on CUDA (the unfused one there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import config as jcfg
from motionclone_tpu.models import motion_module as jmm
from motionclone_tpu.models.embeddings import temporal_positional_encoding
from motionclone_tpu.ops import fused_temporal as jft
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models import motion_module as tmm
from motionclone_tpu_torch.ops import fused_temporal as tft
from test_torch_models import close, load_port, one_torch_thread, random_flax_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, F, H, W, C = 1, 8, 8, 8, 32
HEADS, GROUPS = 4, 8
CFG = dict(num_attention_heads=HEADS, norm_num_groups=GROUPS)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    x = r.standard_normal((B, F, H, W, C)).astype(np.float32)
    jm = jmm.VanillaTemporalModule(cfg=jcfg.MotionModuleConfig(**CFG), attention_impl="xla")
    params = random_flax_params(jm, x, seed=1)
    tm = load_port(tmm.VanillaTemporalModule(C, tcfg.MotionModuleConfig(**CFG)), params)
    return dict(x=x, params=params, tm=tm)


def _plain_matches_jax_kernel(x_np, params, tm, n_attn, max_len):
    p = params["params"]["temporal_transformer"]
    blk = p["transformer_blocks_0"]
    xs = jnp.asarray(x_np).reshape(B, F, H * W, C)
    gw, gb = jft.folded_groupnorm_affine(xs, GROUPS, 1e-6, p["norm"]["scale"],
                                         p["norm"]["bias"])
    attn = tuple(
        jft.AttnWeights(
            ln_scale=blk[f"norms_{i}"]["scale"], ln_bias=blk[f"norms_{i}"]["bias"],
            wq=blk[f"attention_blocks_{i}"]["to_q"]["kernel"],
            wk=blk[f"attention_blocks_{i}"]["to_k"]["kernel"],
            wv=blk[f"attention_blocks_{i}"]["to_v"]["kernel"],
            wo=blk[f"attention_blocks_{i}"]["to_out_0"]["kernel"],
            bo=blk[f"attention_blocks_{i}"]["to_out_0"]["bias"],
        )
        for i in range(n_attn)
    )
    w = jft.TemporalModuleWeights(
        gn_w=gw, gn_b=gb, pe=temporal_positional_encoding(C, max_len)[:F],
        win=p["proj_in"]["kernel"], bin=p["proj_in"]["bias"], attn=attn,
        ffln_scale=blk["ff_norm"]["scale"], ffln_bias=blk["ff_norm"]["bias"],
        wff1=blk["ff"]["net_0"]["proj"]["kernel"], bff1=blk["ff"]["net_0"]["proj"]["bias"],
        wff2=blk["ff"]["net_2"]["kernel"], bff2=blk["ff"]["net_2"]["bias"],
        wout=p["proj_out"]["kernel"], bout=p["proj_out"]["bias"],
    )
    want = jft.fused_temporal_module(xs, w, heads=HEADS)
    x = torch.from_numpy(x_np)
    tt = tm.temporal_transformer
    got = tft.fused_temporal_module_plain(
        x.reshape(B, F, H * W, C), tt.fused_weights(x), heads=HEADS, groups=GROUPS)
    assert len(tt.fused_weights(x).attn) == n_attn
    close(got, want)


def test_plain_matches_jax_kernel(data):
    _plain_matches_jax_kernel(data["x"], data["params"], data["tm"], 2, 24)


def test_plain_matches_jax_kernel_with_one_attention_block(data):
    """The SparseCtrl controlnet's motion modules: one temporal attention
    block, a positional-encoding table of 32 rows."""
    cfg = dict(CFG, attention_block_types=("Temporal_Self",),
               temporal_position_encoding_max_len=32)
    jm = jmm.VanillaTemporalModule(cfg=jcfg.MotionModuleConfig(**cfg), attention_impl="xla")
    params = random_flax_params(jm, data["x"], seed=2)
    tm = load_port(tmm.VanillaTemporalModule(C, tcfg.MotionModuleConfig(**cfg)), params)
    _plain_matches_jax_kernel(data["x"], params, tm, 1, 32)
    # the module's fused route, with one block, against the JAX module
    want, _ = jm.apply(params, data["x"])
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(data["x"]), impl="fused")
    close(got, want)


@pytest.mark.parametrize("jax_impl", ["fused", "xla"])
def test_module_fused_matches_jax(data, jax_impl, monkeypatch):
    calls = []
    plain = tft.fused_temporal_module_plain
    monkeypatch.setattr(tft, "fused_temporal_module_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    want, _ = jmm.VanillaTemporalModule(
        cfg=jcfg.MotionModuleConfig(**CFG), attention_impl=jax_impl).apply(
        data["params"], data["x"])
    with torch.no_grad():
        got, probs = data["tm"](torch.from_numpy(data["x"]), impl="fused")
    close(got, want)
    assert calls == [1] and probs == ()


def test_probs_keep_the_unfused_route(data, monkeypatch):
    """A guidance block (probabilities requested) is never fused, as in JAX."""
    monkeypatch.setattr(tft, "fused_temporal_module_plain", None)
    with torch.no_grad():
        got, probs = data["tm"](torch.from_numpy(data["x"]), return_probs=True, impl="fused")
        want, _ = data["tm"](torch.from_numpy(data["x"]))
    assert len(probs) == 2
    close(got, want.numpy())


@pytest.mark.parametrize("f,s,c,heads", [
    # main path: 64x64 and 32x32 levels fuse, 16x16 and 8x8 (1280) do not
    (16, 4096, 320, 8), (16, 1024, 640, 8), (16, 256, 1280, 8), (16, 64, 1280, 8),
    # the JAX tests' edge cases
    (16, 4095, 320, 8), (4, 4096, 320, 8), (8, 64, 32, 4), (8, 64, 30, 3),
    (8, 64, 64, 2), (7, 64, 32, 4),
])
def test_predicate_matches_jax(f, s, c, heads):
    assert tft.supported(f, s, c, heads) == jft.supported(f, s, c, heads)


# ---------------------------------------------------------------------------
# the shapes of the TMA + wgmma product (csrc/fused_product.cuh), no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2])  # a CFG half, the vanilla pair
@pytest.mark.parametrize("level", range(4))  # 64², 32², 16², 8² latents at 512²
def test_main_path_products_fit_the_product(level, b):
    """Every product kernel 7 launches at UNet3DConfig() widths is a shape
    the wgmma product takes; the levels the predicate leaves unfused launch
    none."""
    from motionclone_tpu_torch.ops import fused_common as fc

    cfg = tcfg.UNet3DConfig()
    mm = cfg.motion_module
    s, c = (64 >> level) ** 2, cfg.block_out_channels[level]
    if not tft.supported(16, s, c, mm.num_attention_heads):
        assert c > tft.MAX_CHANNELS
        return
    prods = tft.products(b, 16, s, c, len(mm.attention_block_types))
    assert len(prods) == 8
    fc.check_products("fused_temporal_module", prods)


def test_kernel_wrapper_refuses_unsupported_shapes_before_launch():
    """C = 32 (the CPU tests' width) has K % 64 != 0: the kernel wrapper
    raises ValueError before it builds or launches anything."""
    bf16 = torch.bfloat16
    mat = lambda o, i: torch.zeros(o, i, dtype=bf16)
    vec = lambda n: torch.zeros(n)
    attn = tft.AttnWeights(vec(C), vec(C), mat(3 * C, C), mat(C, C), vec(C))
    w = tft.TemporalModuleWeights(vec(C), vec(C), None, mat(C, C), vec(C), (attn, attn),
                                  vec(C), vec(C), mat(8 * C, C), vec(8 * C), mat(C, 4 * C),
                                  vec(C), mat(C, C), vec(C))
    x = torch.zeros(B, F, H * W, C, dtype=bf16)
    with pytest.raises(ValueError, match="TMA \\+ wgmma product"):
        tft.fused_temporal_kernel(x, w, heads=HEADS, groups=GROUPS)


# ---------------------------------------------------------------------------
# the kernel's own shape rule and the route on CUDA, no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,c", [(4096, 320), (1024, 640)])  # the levels that fuse
def test_device_predicate_holds_at_sd15_levels(s, c):
    assert tft.supported(16, s, c, 8) and tft.device_supported(s, c)


@pytest.mark.parametrize("n_attn", [1, 2])
def test_device_predicate_refuses_rows_the_layer_norm_cannot_hold(n_attn):
    """C = 1280 (the 16x16 and 8x8 levels): every product fits the wgmma
    product, but the kernel's LayerNorm holds rows of at most 1024 channels
    (its C entry returns "no kernel for this shape"); the JAX predicate
    already leaves these levels unfused (C > 640)."""
    from motionclone_tpu_torch.ops import fused_common as fc

    assert all(fc.product_takes(p) for p in tft.products(1, 16, 256, 1280, n_attn))
    assert not tft.device_supported(256, 1280, n_attn)
    assert not tft.device_supported(64, 1280, n_attn)
    assert tft.device_supported(4096, 320, n_attn) and tft.device_supported(1024, 640, n_attn)
    assert not tft.supported(16, 256, 1280, 8)


@pytest.mark.parametrize("f,s,c,heads", [(8, 64, 80, 2), (16, 256, 80, 2), (8, 64, 240, 3),
                                         (16, 1024, 240, 6)])
def test_narrow_widths_pass_jax_predicate_fail_device_predicate(f, s, c, heads):
    """C = 80 (2 heads of 40) and C = 240: the JAX package fuses them, the
    TMA + wgmma product does not take them (K % 64, N % 160)."""
    assert tft.supported(f, s, c, heads)
    assert not tft.device_supported(s, c)


@pytest.mark.parametrize("c,heads,cpu,cuda", [
    (80, 2, True, False), (240, 3, True, False), (C, HEADS, True, False),
    (320, 8, True, True),
])
def test_module_route_on_shapes(c, heads, cpu, cuda):
    """The route a motion module takes with impl="fused", from the shapes
    alone (the module lives on the meta device): on the CPU the plain
    version wherever the JAX package fuses; on CUDA a C = 80 or 240 module
    (and the CPU tests' C = 32) takes the unfused path instead of a kernel
    that would raise, and SD1.5's C = 320 its kernel as before.  Requested
    probabilities and a frame group keep the unfused route everywhere."""
    with torch.device("meta"):
        m = tmm.TemporalTransformer3D(c, tcfg.MotionModuleConfig(
            num_attention_heads=heads, norm_num_groups=8))
    x_shape = (1, 16, 16, 16, c)
    assert m.fused_route(x_shape, "cpu") == cpu
    assert m.fused_route(x_shape, "cuda") == cuda
    assert not m.fused_route(x_shape, "cpu", return_probs=True)
