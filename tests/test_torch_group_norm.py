"""The differentiable GroupNorm (+ SiLU) of ``ops/group_norm.py`` on the
CPU: its plain forward against ``models/layers.py``'s ``group_norm_nhwc``
bit for bit, the hand-derived backward (the kernel's arithmetic in plain
PyTorch) against autograd through that chain, what its Function keeps for
the backward, the grid plan and the wrappers' refusals, and the module's
CPU path.  The kernels themselves run on the card only (``chip_smoke.py``
phase 2)."""

import pytest
import torch
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import GroupNorm, group_norm_nhwc
from motionclone_tpu_torch.ops import group_norm as gn
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _inputs(shape, groups, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype)
    weight = 1.0 + 0.5 * torch.randn(c, generator=gen)
    bias = 0.5 * torch.randn(c, generator=gen)
    return x, weight, bias


def _reference(x, weight, bias, groups, eps, silu, per_frame):
    """Today's eager chain: group_norm_nhwc per frame (5-D with
    ``per_frame``) or per sample, then F.silu."""
    n = gn.samples(x.shape, per_frame)
    out = group_norm_nhwc(x.reshape(n, *x.shape[-3:]) if x.dim() == 5 and per_frame else x,
                          groups, eps, weight, bias).reshape(x.shape)
    return F.silu(out) if silu else out


# (shape, groups, per_frame): a video per frame, a video over its frames,
# a 4-D batch of images per image
CASES = [((2, 3, 4, 4, 32), 8, True), ((2, 3, 4, 4, 40), 4, False), ((3, 6, 5, 16), 4, True)]


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
@pytest.mark.parametrize("shape,groups,per_frame", CASES, ids=["5d_per_frame", "5d_whole",
                                                               "4d"])
def test_plain_forward_equals_group_norm_nhwc_bit_for_bit(shape, groups, per_frame, silu):
    x, weight, bias = _inputs(shape, groups, seed=1)
    want = _reference(x, weight, bias, groups, 1e-5, silu, per_frame)
    x3 = x.reshape(gn.samples(shape, per_frame), -1, shape[-1])
    y, stats = gn.group_norm_plain(x3, weight, bias, groups, 1e-5, silu)
    assert torch.equal(y.reshape(shape), want)
    assert stats.shape == (2, x3.shape[0], groups) and stats.dtype == torch.float32
    xg = x3.reshape(x3.shape[0], -1, groups, shape[-1] // groups)
    torch.testing.assert_close(stats[0], xg.mean(dim=(1, 3)))
    torch.testing.assert_close(stats[1], torch.rsqrt(xg.var(dim=(1, 3), unbiased=False) + 1e-5))
    # the wrapper without grad is the same plain forward on the CPU
    assert torch.equal(gn.group_norm(x, weight, bias, groups, 1e-5, silu=silu,
                                     per_frame=per_frame), want)


# group widths 1 (the degenerate case), 4, 10 (a group straddles the
# kernel's 8-channel loads) and 80 (SD1.5's 2560 / 32)
@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
@pytest.mark.parametrize("groups,width", [(8, 1), (4, 4), (3, 10), (2, 80)],
                         ids=["cg1", "cg4", "cg10", "cg80"])
def test_hand_derived_backward_equals_autograd(groups, width, silu):
    shape = (2, 3, 5, 4, groups * width)
    x, weight, bias = _inputs(shape, groups, seed=2)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    leaf = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        _reference(leaf, weight, bias, groups, 1e-5, silu, per_frame=True), leaf, dy)
    leaf = x.clone().requires_grad_(True)
    y = gn.group_norm(leaf, weight, bias, groups, 1e-5, silu=silu, per_frame=True)
    (got,) = torch.autograd.grad(y, leaf, dy)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


def _saved(fn):
    """Every tensor autograd saves while ``fn()`` runs its forward."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_function_saves_x_and_the_statistics_only(dtype):
    shape, groups = (2, 4, 4, 4, 32), 8
    x, weight, bias = _inputs(shape, groups, seed=4, dtype=dtype)
    leaf = x.clone().requires_grad_(True)
    saved = _saved(lambda: gn.group_norm(leaf, weight, bias, groups, 1e-5, silu=True))
    big = [t for t in saved if t.numel() >= x.numel()]
    assert [(t.dtype, t.data_ptr()) for t in big] == [(dtype, leaf.data_ptr())]
    assert sum(t.numel() for t in saved if t is not big[0]) == 2 * 8 * groups + 2 * 32
    # the eager chain keeps f32 copies of x's size: the check sees them
    leaf = x.clone().requires_grad_(True)
    eager = _saved(lambda: _reference(leaf, weight.requires_grad_(True), bias, groups, 1e-5,
                                      True, per_frame=True))
    assert sum(t.dtype == torch.float32 and t.numel() >= x.numel() for t in eager) >= 3


def test_module_on_a_cpu_tensor_runs_the_plain_chain():
    torch.manual_seed(5)
    norm = GroupNorm(8, 32, eps=1e-6)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.3)
        norm.bias.normal_(0.0, 0.3)
    x = torch.randn(2, 3, 4, 4, 32).requires_grad_(True)
    before = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    y = norm(x, silu=True)
    assert torch.equal(y, _reference(x, norm.weight, norm.bias, 8, 1e-6, True, per_frame=True))
    assert type(y.grad_fn).__name__ == "SiluBackward0"
    assert "_fused_pack" not in norm.__dict__  # no f32 copy of the parameters is cached
    y.sum().backward()
    assert norm.weight.grad is not None  # autograd's chain reaches the parameters
    assert (gn.group_norm_fwd.launches, gn.group_norm_bwd.launches) == before


@pytest.mark.parametrize("n,s,want", [(32, 4096, 32), (64, 4096, 16), (32, 64, 2),
                                      (4, 262144, 256), (1, 16, 1), (2, 256, 8)])
def test_grid_plan(n, s, want):
    assert gn.chunks(n, s) == want
    assert n * want >= min(gn.GRID_BLOCKS, n * max(1, s // gn.CHUNK_MIN_PIXELS))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x, weight, bias = _inputs((2, 16, 32), 8, seed=6)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        gn.group_norm_fwd(x, weight, bias, 8, 1e-5, False)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        gn.group_norm_bwd(x, x, torch.zeros(2, 2, 8), weight, bias, 8, False)
