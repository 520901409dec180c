"""Port kernel 8 (fused ResnetBlock3D) against the JAX package, on the CPU.

* the port's plain version (``ops/fused_resnet.fused_resnet_block_plain``,
  on the module's own weights in the kernel's layout) against the JAX
  kernel function ``fused_resnet_block`` in Pallas interpret mode, at the
  sizes of tests/test_fused_resnet.py, f32, atol 1e-4;
* the port's module with ``impl="fused"`` against the JAX module with
  ``attention_impl="fused"`` and ``"xla"``, checking that the fused route
  was taken;
* the port's copy of the routing predicate against JAX's at every
  main-path shape and at the JAX tests' edge cases;
* the forward-only wrapper's refusal of inputs that require grad, and the
  kernel library's hash over the shared headers;
* without JAX: the kernel's own shape rule (``device_supported``) at every
  SD1.5 shape and at shapes it refuses, the route a module takes on CUDA
  (the unfused one where the kernel does not take the shapes), the
  convolution's products against the product's shape rule, the wrapper's
  refusal before any launch, the producer's tap addressing (``conv_a_tile``)
  against ``torch.nn.functional.unfold``, and the convolution's plain
  version."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.models import resnet as jres
from motionclone_tpu.ops import fused_resnet as jfr
from motionclone_tpu_torch.models import resnet as tres
from motionclone_tpu_torch.ops import build as kbuild
from motionclone_tpu_torch.ops import fused_resnet as tfr
from test_torch_models import close, load_port, one_torch_thread, random_flax_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, F, H, W = 1, 2, 8, 8
GROUPS, TEMB_DIM, EPS = 8, 24, 1e-5
CASES = {"shortcut": (32, 48), "identity": (48, 48)}


def _jax_weights(p, cin, cout):
    """The JAX module's fused-route weights (models/resnet.py)."""
    sc = cin != cout
    return jfr.ResnetWeights(
        gn1_scale=p["norm1"]["scale"], gn1_bias=p["norm1"]["bias"],
        w1=p["conv1"]["kernel"].reshape(9 * cin, cout), b1=p["conv1"]["bias"],
        gn2_scale=p["norm2"]["scale"], gn2_bias=p["norm2"]["bias"],
        w2=p["conv2"]["kernel"].reshape(9 * cout, cout), b2=p["conv2"]["bias"],
        wsc=p["conv_shortcut"]["kernel"].reshape(cin, cout) if sc else None,
        bsc=p["conv_shortcut"]["bias"] if sc else None,
    )


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cin, cout = CASES[request.param]
    r = np.random.default_rng(0)
    x = r.standard_normal((B, F, H, W, cin)).astype(np.float32)
    temb = r.standard_normal((B, TEMB_DIM)).astype(np.float32)
    jm = jres.ResnetBlock3D(out_channels=cout, groups=GROUPS, eps=EPS, attention_impl="xla")
    params = random_flax_params(jm, x, temb, seed=1)
    tm = load_port(tres.ResnetBlock3D(cin, cout, TEMB_DIM, groups=GROUPS, eps=EPS), params)
    return dict(cin=cin, cout=cout, x=x, temb=temb, params=params, tm=tm)


def test_plain_matches_jax_kernel(case):
    p = case["params"]["params"]
    t = p["time_emb_proj"]
    silu = case["temb"] / (1 + np.exp(-case["temb"]))
    temb_out = (silu @ np.asarray(t["kernel"]) + np.asarray(t["bias"])).astype(np.float32)
    want = jfr.fused_resnet_block(
        jnp.asarray(case["x"]), jnp.asarray(temb_out),
        _jax_weights(p, case["cin"], case["cout"]), groups=GROUPS, eps=EPS)
    got = tfr.fused_resnet_block_plain(
        torch.from_numpy(case["x"]), torch.from_numpy(temb_out),
        case["tm"].fused_weights(torch.float32), groups=GROUPS, eps=EPS)
    close(got, want)


@pytest.mark.parametrize("jax_impl", ["fused", "xla"])
def test_module_fused_matches_jax(case, jax_impl, monkeypatch):
    calls = []
    plain = tfr.fused_resnet_block_plain
    monkeypatch.setattr(tfr, "fused_resnet_block_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    want = jres.ResnetBlock3D(out_channels=case["cout"], groups=GROUPS, eps=EPS,
                              attention_impl=jax_impl).apply(
        case["params"], case["x"], case["temb"])
    with torch.no_grad():
        got = case["tm"](torch.from_numpy(case["x"]), torch.from_numpy(case["temb"]), "fused")
    close(got, want)
    assert calls == [1]


# (H = W, Cin, Cout) of the 22 resnets of one SD1.5 UNet forward at 512x512
SD15_RESNETS = (
    [(64, 320, 320)] * 2 + [(32, 320, 640), (32, 640, 640)]          # down 0, 1
    + [(16, 640, 1280), (16, 1280, 1280)] + [(8, 1280, 1280)] * 4    # down 2, 3, mid
    + [(8, 2560, 1280)] * 3 + [(16, 2560, 1280)] * 2 + [(16, 1920, 1280)]  # up 0, 1
    + [(32, 1920, 640), (32, 1280, 640), (32, 960, 640)]             # up 2
    + [(64, 960, 320)] + [(64, 640, 320)] * 2                        # up 3
)
# each shape at 16 frames, B = 1 (one CFG half) and B = 2 (the vanilla pair)
MAIN_PATH = [((b, 16, hw, hw, cin), cout)
             for b in (1, 2) for hw, cin, cout in sorted(set(SD15_RESNETS))]
EDGES = [
    ((1, 16, 64, 64, 320), 320, 32, "scale_shift", 2),
    ((1, 2, 8, 8, 32), 48, 8, "default", 4),
    ((1, 2, 8, 4, 32), 48, 8, "default", 4),   # width not a multiple of 8
    ((1, 2, 2, 8, 32), 48, 8, "default", 4),   # height below the 3x3 window
    ((1, 2, 8, 8, 36), 48, 8, "default", 4),   # channels not a multiple of 8
    ((1, 2, 8, 8, 32), 48, 6, "default", 4),   # groups do not divide channels
    ((1, 16, 64, 64, 640), 640, 32, "default", 4),  # f32 frame over budget
    ((16, 64, 64, 320), 320, 32, "default", 2),     # not a video tensor
]


@pytest.mark.parametrize(
    "x_shape,cout,groups,norm,itemsize",
    [(s, c, 32, "default", 2) for s, c in MAIN_PATH] + EDGES,
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_predicate_matches_jax(x_shape, cout, groups, norm, itemsize):
    assert tfr.supported(x_shape, cout, groups, norm, itemsize) == jfr.supported(
        x_shape, cout, groups, norm, itemsize)


def test_predicate_fuses_eleven_resnets_per_forward():
    """Down 0: 2, down 1: 2, down 2: 1, up 2: 3, up 3: 3 (the 1280-wide and
    the 2560-input resnets are over the weight budget)."""
    fused = [r for r in SD15_RESNETS if tfr.supported((1, 16, r[0], r[0], r[1]), r[2], 32)]
    assert len(SD15_RESNETS) == 22 and len(fused) == 11


def test_packed_weights_are_cached_until_a_parameter_changes(case):
    """The kernel-layout weights are built once per module and dtype, and
    rebuilt when a parameter is changed in place (a new state dict)."""
    tm = case["tm"]
    saved = tm.conv1.weight.detach().clone()
    first = tm.fused_weights(torch.float32)
    assert tm.fused_weights(torch.float32) is first
    with torch.no_grad():
        tm.conv1.weight.mul_(2.0)
    again = tm.fused_weights(torch.float32)
    assert again is not first
    torch.testing.assert_close(again.w1, 2.0 * first.w1)
    with torch.no_grad():
        tm.conv1.weight.copy_(saved)


def test_fused_refuses_grad(case):
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        case["tm"](x, torch.from_numpy(case["temb"]), "fused")


def test_library_hash_covers_headers(tmp_path):
    """An edited shared header (csrc/*.cuh) must rebuild the library: the
    library's name carries a hash of the sources and the headers."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC_DIR, csrc)
    before = kbuild._digest(csrc)
    assert before == kbuild._digest(kbuild.CSRC_DIR)
    header = csrc / "fused_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = kbuild._digest(csrc)
    assert after_header != before
    source = csrc / "fused_resnet.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert kbuild._digest(csrc) not in (before, after_header)


# ---------------------------------------------------------------------------
# the kernel's own shape rule and the route on CUDA, no JAX
# ---------------------------------------------------------------------------

FUSED_MAIN_PATH = [(s, c) for s, c in MAIN_PATH if tfr.supported(s, c, 32)]


@pytest.mark.parametrize("x_shape,cout", FUSED_MAIN_PATH,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_device_predicate_holds_at_sd15_shapes(x_shape, cout):
    """Every resnet the JAX package fuses at SD1.5 width is a shape kernel 8
    takes, and each of its products passes the product's shape rule."""
    from motionclone_tpu_torch.ops import fused_common as fc

    assert tfr.device_supported(x_shape, cout)
    b, f, h, w, cin = x_shape
    prods = tfr.products(b * f, h, w, cin, cout)
    assert [p.label for p in prods] == (
        ["conv1", "conv2"] if cin == cout else ["conv1", "shortcut", "conv2"])
    fc.check_products("fused_resnet_block", prods)
    tfr.check_shapes("fused_resnet_block", x_shape, cout)


def test_cuda_route_fuses_the_same_eleven_resnets_per_forward():
    """On CUDA the route fuses exactly the resnets the JAX predicate fuses
    at SD1.5 width: 11 per forward, as before the kernel's rule was added."""
    from motionclone_tpu_torch.ops.fused_common import takes_kernel

    def route(dev, r):
        shape = (1, 16, r[0], r[0], r[1])
        return takes_kernel(dev, tfr.supported(shape, r[2], 32),
                            lambda: tfr.device_supported(shape, r[2]))

    assert [route("cuda", r) for r in SD15_RESNETS] == [route("cpu", r) for r in SD15_RESNETS]
    assert sum(route("cuda", r) for r in SD15_RESNETS) == 11


@pytest.mark.parametrize("x_shape,cout", [
    ((1, 2, 8, 8, 32), 48),      # the CPU tests' widths: Cin % 64 != 0
    ((1, 2, 8, 8, 96), 320),     # Cin % 64 != 0
    ((1, 2, 16, 16, 64), 64),    # Cout % 160 != 0
    ((1, 2, 16, 16, 64), 160),   # Cout % 64 != 0 (conv2's input)
    ((1, 2, 8, 24, 64), 320),    # H·W % 128 != 0
    ((1, 2, 16, 48, 64), 320),   # min(W, 128) does not divide 128
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_device_predicate_refuses_shapes_the_jax_package_fuses(x_shape, cout):
    assert tfr.supported(x_shape, cout, 8)
    assert not tfr.device_supported(x_shape, cout)
    with pytest.raises(ValueError, match="TMA \\+ wgmma"):
        tfr.check_shapes("fused_resnet_block", x_shape, cout)


@pytest.mark.parametrize("cin,cout,x_shape,cpu,cuda", [
    (32, 48, (1, 2, 8, 8, 32), True, False),           # the CPU tests' block
    (64, 320, (1, 2, 8, 24, 64), True, False),         # H·W % 128 != 0
    (320, 320, (1, 16, 64, 64, 320), True, True),      # SD1.5, down 0
    (640, 1280, (1, 16, 16, 16, 640), True, True),     # SD1.5, down 2
    (1280, 1280, (1, 16, 16, 16, 1280), False, False), # over the weight budget
])
def test_module_route_on_shapes(cin, cout, x_shape, cpu, cuda):
    """The route a ResnetBlock3D takes with impl="fused", from the shapes
    alone (the module lives on the meta device): the kernel's plain version
    on the CPU wherever the JAX package fuses, kernel 8 on CUDA only where
    it takes the shapes, else the unfused path."""
    with torch.device("meta"):
        m = tres.ResnetBlock3D(cin, cout, 1280, groups=8 if cin == 32 else 32)
    assert m.fused_route(x_shape, "cpu") == cpu
    assert m.fused_route(x_shape, "cuda") == cuda


@pytest.mark.parametrize("x_shape,cout", [((1, 2, 8, 8, 32), 48), ((1, 2, 8, 24, 64), 320)])
def test_kernel_wrapper_refuses_unsupported_shapes_before_launch(x_shape, cout):
    """Kernel 8's wrapper raises ValueError on a shape it does not take
    before it builds or launches anything."""
    b, f, h, w, cin = x_shape
    bf16 = torch.bfloat16
    vec = lambda n: torch.zeros(n)
    sc = cin != cout
    weights = tfr.ResnetWeights(
        vec(cin), vec(cin), torch.zeros(cout, 9 * cin, dtype=bf16), vec(cout), vec(cout),
        vec(cout), torch.zeros(cout, 9 * cout, dtype=bf16), vec(cout),
        torch.zeros(cout, cin, dtype=bf16) if sc else None, vec(cout) if sc else None)
    x = torch.zeros(x_shape, dtype=bf16)
    with pytest.raises(ValueError, match="TMA \\+ wgmma"):
        tfr.fused_resnet_kernel(x, torch.zeros(b, cout, dtype=bf16), weights,
                                groups=8, eps=1e-5)


# ---------------------------------------------------------------------------
# the producer's tap addressing and the convolution's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf,h,w,cin", [
    (2, 16, 16, 64),    # W = 16: boxes of 8 image rows, 2 tiles per frame
    (2, 8, 32, 128),    # W = 32: boxes of 4 rows, 2 channel tiles per tap
    (3, 4, 64, 64),     # W = 64: boxes of 2 rows; 3 frames
    (2, 2, 256, 64),    # W = 256: boxes of half an image row
])
def test_tap_addressing_matches_unfold(bf, h, w, cin):
    """The im2col matrix assembled from the A tiles the 4-D TMA loads would
    deliver (zero fill outside the frame, no tap reading the neighbouring
    frame) is ``unfold`` of the same frames, column (dy·3 + dx)·Cin + ci."""
    r = np.random.default_rng(bf * w + cin)
    act = torch.from_numpy(r.standard_normal((bf, h, w, cin)).astype(np.float32))
    m_tiles, k_tiles = bf * h * w // tfr.CONV_BM, 9 * cin // 64
    a = torch.cat([torch.cat([tfr.conv_a_tile(act, i, k) for k in range(k_tiles)], dim=1)
                   for i in range(m_tiles)], dim=0)
    u = torch.nn.functional.unfold(act.permute(0, 3, 1, 2), 3, padding=1)
    want = u.reshape(bf, cin, 9, h * w).permute(0, 3, 2, 1).reshape(bf * h * w, 9 * cin)
    assert torch.equal(a, want)
    # the first tap's box of a frame's first tile starts above and left of it
    (c0, x, y, frame), box = tfr.conv_box(h, w, cin, m_tiles - 1, 0)
    assert (c0, x, frame) == (0, -1 if w <= 128 else w - 128 - 1, bf - 1)
    assert box == (64, min(w, 128), 128 // min(w, 128), 1)


@pytest.mark.parametrize("flavour", ["conv1", "conv2_bf16", "conv2_f32"])
def test_conv3x3_plain_version(flavour):
    """The convolution alone on the CPU (its plain version) against
    ``conv2d`` of the same frames with its epilogue written out: f32, one
    rounding at the store."""
    r = np.random.default_rng(4)
    bf, h, w, cin, cout, frames = 4, 8, 16, 64, 160, 2
    rnd = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    act = rnd(bf, h, w, cin).to(torch.bfloat16)
    wk = (rnd(cout, cin, 3, 3) / 24).to(torch.bfloat16)
    bias = rnd(cout)
    y = torch.nn.functional.conv2d(act.float().permute(0, 3, 1, 2), wk.float(), padding=1)
    y = y.permute(0, 2, 3, 1) + bias
    wkl = tfr.conv_weight(wk)
    if flavour == "conv1":
        temb = rnd(bf // frames, cout).to(torch.bfloat16)
        got = tfr.conv3x3(act, wkl, bias, temb, frames=frames, out_dtype=torch.float32)
        want = y + temb.float().repeat_interleave(frames, 0)[:, None, None, :]
    else:
        dt = torch.bfloat16 if flavour == "conv2_bf16" else torch.float32
        res = rnd(bf, h, w, cout).to(dt)
        got = tfr.conv3x3(act, wkl, bias, res=res)
        want = (y + res.float()).to(torch.bfloat16)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-4)
