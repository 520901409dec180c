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
