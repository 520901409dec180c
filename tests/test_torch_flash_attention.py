"""Port flash attention (plain version on CPU) vs the JAX Pallas kernel.

The JAX side is ``motionclone_tpu.ops.flash_attention.flash_attention`` in
Pallas interpret mode on the CPU; the port side is
``motionclone_tpu_torch.ops.flash_attention.flash_attention`` on CPU
tensors, which dispatches to its plain PyTorch version.  Same numpy inputs,
f32, atol 1e-5 / rtol 1e-4.  Logits stay well inside the JAX kernel's +-75
clamp (unit-normal q/k, scale d**-0.5).  The head dims with a CUDA kernel
(40, 80, 160: the reduction padded to a multiple of 16 on the card) run at
a short sequence; the ragged 77-token cross-attention (Sk != Sq) runs
against JAX's whole-KV kernels, which take any key count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.ops.flash_attention import _flash_fwd, flash_attention as jax_flash
from motionclone_tpu_torch.ops import flash_attention as fa
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, S, H = 2, 256, 2
ATOL, RTOL = 1e-5, 1e-4
# the kernels' head dims (SD1.5: 320/640/1280 channels over 8 heads), at a
# sequence short enough for Pallas interpret mode
KERNEL_DIMS = [40, 80, 160]
SHORT_S = 64
TEXT_TOKENS = 77


def _inputs(seed, d, s=None, sk=None):
    rng = np.random.default_rng(seed)
    s = s or (S if d <= 16 else SHORT_S)
    sk = sk or s
    return [rng.standard_normal((B, n, H * d)).astype(np.float32)
            for n in (s, sk, sk, s)]


@pytest.mark.parametrize("d", [8, 16, *KERNEL_DIMS])
def test_forward_and_lse_match_jax(d):
    q, k, v, _ = _inputs(d, d)
    scale = d**-0.5
    out_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale, H, 128, 4096)
    out_t, lse_t = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, scale
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)
    # the public entry point dispatches CPU tensors to the plain version
    out_d = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), heads=H, scale=scale)
    np.testing.assert_array_equal(out_d.numpy(), out_t.numpy())


@pytest.mark.parametrize("d", [8, 16, *KERNEL_DIMS])
def test_gradients_match_jax(d):
    q, k, v, cot = _inputs(100 + d, d)
    scale = d**-0.5
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, scale=scale, heads=H),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads_j = vjp(jnp.asarray(cot))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, heads=H, scale=scale)
    grads_t = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    for gt, gj, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")
    # the plain backward helper the chip check compares the kernel with
    grads_h = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, cot)), H, scale
    )
    for gh, gt in zip(grads_h, grads_t):
        np.testing.assert_allclose(gh.numpy(), gt.numpy(), atol=1e-6)


def test_cross_attention_forward_matches_jax():
    """Sq = 64 queries against the 77 text tokens, d = 40: the ragged last
    key tile of the kernel, masked by key index."""
    d = 40
    q, k, v, _ = _inputs(7, d, s=SHORT_S, sk=TEXT_TOKENS)
    scale = d**-0.5
    out_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale, H, 128, 4096)
    out_t, lse_t = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, scale
    )
    assert out_t.shape == (B, SHORT_S, H * d) and lse_t.shape == (B, H, SHORT_S)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)


def test_cross_attention_gradients_match_jax():
    d = 40
    q, k, v, cot = _inputs(8, d, s=SHORT_S, sk=TEXT_TOKENS)
    scale = d**-0.5
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, scale=scale, heads=H),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads_j = vjp(jnp.asarray(cot))
    grads_t = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, cot)), H, scale
    )
    for gt, gj, name in zip(grads_t, grads_j, "qkv"):
        assert gt.shape == gj.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize(
    "kind", ["cpu_tensor", "float32", "head_dim", "non_contiguous"]
)
def test_kernel_wrapper_rejects_what_it_cannot_take(kind):
    """The kernel wrappers validate device, dtype, head dim and layout before
    any launch (on a card too), and never fall back to the plain version."""
    d = 40 if kind != "head_dim" else 48
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    x = torch.zeros(1, 64, H * d, dtype=dtype)
    if kind == "non_contiguous":
        x = torch.zeros(1, H * d, 64, dtype=dtype).transpose(1, 2)
    with pytest.raises(ValueError):
        fa.flash_fwd(x, x, x, H, d**-0.5)
    lse = torch.zeros(1, H, 64)
    with pytest.raises(ValueError):
        fa.flash_bwd(x, x, x, x, lse, x, H, d**-0.5)
