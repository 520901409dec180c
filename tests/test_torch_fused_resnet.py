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
  kernel library's hash over the shared headers."""

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
from test_torch_models import close, load_port, random_flax_params

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
