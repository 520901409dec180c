"""Port temporal attention (plain version on CPU) vs the JAX Pallas kernel.

The JAX side is ``motionclone_tpu.ops.temporal_attention.temporal_attention``
in Pallas interpret mode on the CPU; the port side is
``motionclone_tpu_torch.ops.temporal_attention.temporal_attention`` on CPU
tensors, which dispatches to its plain PyTorch version.  Same numpy inputs,
f32, atol 1e-5 / rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.ops.temporal_attention import (
    _temporal_fwd,
    temporal_attention as jax_temporal,
)
from motionclone_tpu_torch.ops import temporal_attention as ta
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, F, S, H = 2, 8, 64, 2
ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, F, S, H * d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("d", [8, 16])
def test_forward_and_lse_match_jax(d):
    q, k, v, _ = _inputs(d, d)
    scale = d**-0.5
    out_j, lse_j = _temporal_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale, 16, H)
    out_t, lse_t = ta.temporal_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, scale
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    # JAX lse: (B, S/ts, heads, F*ts) with row f*ts + s; the port's (B, S, heads, F)
    lse_j = np.asarray(lse_j).reshape(B, S // 16, H, F, 16)
    lse_j = lse_j.transpose(0, 1, 4, 2, 3).reshape(B, S, H, F)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=ATOL, rtol=RTOL)
    out_d = ta.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads=H, scale=scale)
    np.testing.assert_array_equal(out_d.numpy(), out_t.numpy())


@pytest.mark.parametrize("d", [8, 16])
def test_gradients_match_jax(d):
    q, k, v, cot = _inputs(200 + d, d)
    scale = d**-0.5
    _, vjp = jax.vjp(
        lambda a, b, c: jax_temporal(a, b, c, heads=H, scale=scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads_j = vjp(jnp.asarray(cot))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ta.temporal_attention(qt, kt, vt, heads=H, scale=scale)
    grads_t = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    for gt, gj, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")
    grads_h = ta.temporal_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, cot)), H, scale
    )
    for gh, gt in zip(grads_h, grads_t):
        np.testing.assert_allclose(gh.numpy(), gt.numpy(), atol=1e-6)


@pytest.mark.parametrize("kind", ["cpu_tensor", "float32", "frames", "head_dim"])
def test_kernel_wrapper_rejects_what_it_cannot_take(kind):
    """The kernel wrappers validate device, dtype, frame count and head dim
    before any launch, and never fall back to the plain version."""
    f = 8 if kind == "frames" else 16
    d = 48 if kind == "head_dim" else 40
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    x = torch.zeros(1, f, 16, H * d, dtype=dtype)
    with pytest.raises(ValueError):
        ta.temporal_fwd(x, x, x, H, d**-0.5)
    with pytest.raises(ValueError):
        ta.temporal_bwd(x, x, x, torch.zeros(1, 16, H, f), x, H, d**-0.5)


@pytest.mark.parametrize("kind,match", [
    ("square_query", "query frames"), ("odd_query", "query frames"),
    ("kv_frames", "shapes"), ("batch", "shapes"), ("head_dim", "head dim"),
    ("cpu_tensor", "CUDA"),
])
def test_rect_wrappers_reject_what_they_cannot_take(kind, match):
    """Kernels 3r and 4r take q of 8, 4, 2 or 1 frames against k/v of 16
    with the same B, S and width; the square wrappers refuse a rectangular
    pair.  Shapes are checked before the device, so each case names its
    fault here on the CPU."""
    fq = {"square_query": 16, "odd_query": 3}.get(kind, 8)
    fk = 8 if kind == "kv_frames" else 16
    d = 48 if kind == "head_dim" else 40
    q = torch.zeros(1, fq, 16, H * d, dtype=torch.bfloat16)
    kv = torch.zeros(2 if kind == "batch" else 1, fk, 16, H * d, dtype=torch.bfloat16)
    lse = torch.zeros(1, 16, H, fq)
    with pytest.raises(ValueError, match=match):
        ta.temporal_fwd_rect(q, kv, kv, H, d**-0.5)
    with pytest.raises(ValueError, match=match):
        ta.temporal_bwd_rect(q, kv, kv, lse, q, H, d**-0.5)
    if kind == "cpu_tensor":
        with pytest.raises(ValueError, match="query frames"):
            ta.temporal_fwd(q, kv, kv, H, d**-0.5)  # the square kernel: 16 q frames


# the main path's (pixels, head dim) at 512x512 (64x64 .. 8x8 latents, 8
# heads): chip_smoke.py's ATTN_SHAPES
MAIN_PATH = ((4096, 40), (1024, 80), (256, 160), (64, 160))


def _assert_runs_cover(runs, batch, frames, pixels, width):
    """Row runs (tile, b, frame, pixel, c0, c1) cover every channel of every
    (b, frame, pixel) row of a (batch, frames, pixels, width) tensor exactly
    once."""
    key = (runs[:, 1] * frames + runs[:, 2]) * pixels + runs[:, 3]
    order = np.lexsort((runs[:, 4], key))
    key, c0, c1 = key[order], runs[order, 4], runs[order, 5]
    assert (c1 > c0).all()
    new = np.r_[True, key[1:] != key[:-1]]
    end = np.r_[key[1:] != key[:-1], True]
    assert new.sum() == batch * frames * pixels
    assert key.min() >= 0 and key.max() < batch * frames * pixels
    assert (c0[new] == 0).all() and (c1[end] == width).all()
    # within a row, each run starts where the previous ended: no gap, no overlap
    assert (c1[:-1][~end[:-1]] == c0[1:][~new[1:]]).all()


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("fq", [16, 8, 4, 2, 1])
@pytest.mark.parametrize("s,d", MAIN_PATH)
def test_tile_plan_covers_every_element_once(s, d, fq, backward):
    """The kernels' tile plan at every main-path shape, each head dim and
    each query frame count, at B = 1 and 2: every element of q, k, v (and
    dO), of out, dq, dk, dv and every lse vector is in exactly one tile,
    no tile splits a head, every row run is a 16-byte-aligned bulk copy,
    and each tile goes to one step of one warp."""
    heads = 8
    width = heads * d
    for batch in (1, 2):
        plan = ta.tile_plan(batch, fq, s, heads, d, backward)
        tiles = plan["tiles"]
        assert len(tiles) == batch * s * width // ta.TILE_CHANNELS
        assert (tiles[:, 3] % d == 0).all() and (tiles[:, 4] % d == 0).all()
        assert ((tiles[:, 4] - tiles[:, 3]) == ta.TILE_CHANNELS).all()
        assert ((tiles[:, 2] - tiles[:, 1]) == ta.TILE_PIXELS).all()
        frames = {"q": fq, "dout": fq, "out": fq, "dq": fq, "k": 16, "v": 16,
                  "dk": 16, "dv": 16}
        names = ({"q", "k", "v", "dout"}, {"dq", "dk", "dv"}) if backward else (
            {"q", "k", "v"}, {"out"})
        assert (set(plan["loads"]), set(plan["stores"])) == names
        for name, runs in {**plan["loads"], **plan["stores"]}.items():
            _assert_runs_cover(runs, batch, frames[name], s, width)
            tile = tiles[runs[:, 0]]
            assert (runs[:, 1] == tile[:, 0]).all()
            assert ((runs[:, 3] >= tile[:, 1]) & (runs[:, 3] < tile[:, 2])).all()
            assert ((runs[:, 4] == tile[:, 3]) & (runs[:, 5] == tile[:, 4])).all()
            offset = (((runs[:, 1] * frames[name] + runs[:, 2]) * s + runs[:, 3]) * width
                      + runs[:, 4]) * 2
            assert (offset % 16 == 0).all() and ((runs[:, 5] - runs[:, 4]) * 2 % 16 == 0).all()
        lse = plan["lse"]  # (tile, b, pixel, h0, h1): one FQ-vector per head
        _assert_runs_cover(np.insert(lse, 2, 0, axis=1), batch, 1, s, heads)
        blocks, nw = plan["grid"]
        assert blocks <= 132 and 1 <= nw <= 16
        steps = plan["warp"] * len(tiles) + plan["iteration"]
        assert np.unique(steps).size == len(tiles) and plan["warp"].max() < blocks * nw


@pytest.mark.parametrize("heads,d", [(2, 40), (6, 40), (3, 80), (1, 160)])
def test_tile_plan_partial_channel_slice(heads, d):
    """Widths that are not a multiple of the 160-channel tile: the last
    slice holds fewer whole heads, and every element is still covered once."""
    plan = ta.tile_plan(2, 4, 12, heads, d, backward=True)
    tiles = plan["tiles"]
    assert (tiles[:, 3] % d == 0).all() and (tiles[:, 4] % d == 0).all()
    assert ((tiles[:, 4] - tiles[:, 3]) <= ta.TILE_CHANNELS).all()
    for name, runs in {**plan["loads"], **plan["stores"]}.items():
        frames = 4 if name in ("q", "dout", "dq") else 16
        _assert_runs_cover(runs, 2, frames, 12, heads * d)
    _assert_runs_cover(np.insert(plan["lse"], 2, 0, axis=1), 2, 1, 12, heads)


def test_warps_per_block_as_the_design_note_states():
    """Shared memory holds 7 warps' rings of the square forward, 5 of its
    backward (csrc/temporal_attention.cu)."""
    assert ta.warps_per_block(40, 16, False) == 7
    assert ta.warps_per_block(40, 16, True) == 5
    assert ta.warps_per_block(160, 8, False) == 8
    assert all(1 <= ta.warps_per_block(d, fq, bwd) <= 16 for d in (40, 80, 160)
               for fq in (16, 8, 4, 2, 1) for bwd in (False, True))


@pytest.mark.parametrize("fq,d", [(8, 8), (8, 16), (4, 16)])
def test_bf16_forward_rounds_probabilities_as_jax(fq, d):
    """On bf16 inputs the plain forward rounds P to bf16 before P @ V, as
    JAX's ``_temporal_fwd`` (interpret mode) does.  Tolerance: the same
    rounding points give the same bf16 bits except where an f32 value lies
    within summation-order noise of a bf16 rounding boundary, so at least
    99.9% of out must be bit-equal and all of it within one bf16 ulp (rtol
    2**-7; without the rounding of P about 40% of out differs); lse is f32
    from bf16 inputs on both sides: atol 1e-4."""
    rng = np.random.default_rng(300 + fq + d)
    fk = 8
    q = rng.standard_normal((B, fq, S, H * d)).astype(np.float32)
    k, v = (rng.standard_normal((B, fk, S, H * d)).astype(np.float32) for _ in range(2))
    scale = d**-0.5
    out_j, lse_j = _temporal_fwd(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
                                 scale, 16, H)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out_t, lse_t = ta.temporal_attention_plain(qt, kt, vt, H, scale)
    assert out_t.dtype == torch.bfloat16
    got, want = out_t.float().numpy(), np.asarray(out_j, dtype=np.float32)
    assert (got == want).mean() >= 0.999
    np.testing.assert_allclose(got, want, atol=0, rtol=2**-7)
    lse_j = np.asarray(lse_j).reshape(B, S // 16, H, fq, 16)
    lse_j = lse_j.transpose(0, 1, 4, 2, 3).reshape(B, S, H, fq)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4)
