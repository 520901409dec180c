"""Port model modules vs the JAX package's modules, on the CPU in f32.

Each JAX module (``attention_impl="xla"``) gets a random, fan-in-scaled
flax parameter tree made with numpy; ``weights/from_jax.py`` carries it into
the port's module with a strict ``load_state_dict`` (so every key maps both
ways); both see the same numpy inputs.  atol 1e-4.

The helpers here are shared with test_torch_pipeline.py."""

import contextlib
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import config as jcfg
from motionclone_tpu.models import attention as jattn
from motionclone_tpu.models import clip_text as jclip
from motionclone_tpu.models import motion_module as jmm
from motionclone_tpu.models import resnet as jres
from motionclone_tpu.models import unet3d as junet
from motionclone_tpu.models import vae as jvae
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models import attention as tattn
from motionclone_tpu_torch.models import clip_text as tclip
from motionclone_tpu_torch.models import motion_module as tmm
from motionclone_tpu_torch.models import resnet as tres
from motionclone_tpu_torch.models import unet3d as tunet
from motionclone_tpu_torch.models import vae as tvae
from motionclone_tpu_torch.weights.from_jax import (
    clip_state_dict_from_flax,
    flax_path_to_key,
    state_dict_from_flax,
)

ATOL = 1e-4
GUIDANCE = ("up_blocks.1",)


# the nice value a port test module's worker runs at (see ``yield_cpu``)
PORT_TEST_NICE = 10


def _can_restore_priority() -> bool:
    """Whether this process may lower a thread's nice value again (that
    takes CAP_SYS_NICE), probed on a thread of its own."""
    ok = []

    def probe():
        me = threading.get_native_id()
        base = os.getpriority(os.PRIO_PROCESS, me)
        try:
            os.setpriority(os.PRIO_PROCESS, me, base + 1)
            os.setpriority(os.PRIO_PROCESS, me, base)
            ok.append(True)
        except OSError:
            pass

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return bool(ok)


@contextlib.contextmanager
def yielding_cpu():
    """The port's test modules run beside the JAX package's on the same
    cores, and the longest of those (a single-threaded XLA compile) sets
    the suite's wall: inside this context every thread of this process,
    and every process it starts, runs at nice PORT_TEST_NICE, then each
    thread gets its own priority back.  Where a priority could not be
    given back, nothing is changed."""
    if not os.path.isdir("/proc/self/task") or not _can_restore_priority():
        yield
        return
    base = os.getpriority(os.PRIO_PROCESS, threading.get_native_id())
    saved = {}
    for tid in map(int, os.listdir("/proc/self/task")):
        try:
            saved[tid] = os.getpriority(os.PRIO_PROCESS, tid)
            os.setpriority(os.PRIO_PROCESS, tid, saved[tid] + PORT_TEST_NICE)
        except OSError:  # the thread ended
            pass
    try:
        yield
    finally:
        for tid in map(int, os.listdir("/proc/self/task")):
            try:  # threads started inside take the process's priority
                os.setpriority(os.PRIO_PROCESS, tid, saved.get(tid, base))
            except OSError:
                pass


@pytest.fixture(scope="module")
def one_torch_thread():
    """The test workers share the machine's cores: torch's intra-op pool at
    full width in each of them would oversubscribe the cores (its small
    ops then wait on descheduled threads), so a module that takes this
    fixture (``pytestmark = pytest.mark.usefixtures("one_torch_thread")``)
    runs on one, and yields the CPU to the JAX package's tests
    (``yielding_cpu``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with yielding_cpu():
        yield
    torch.set_num_threads(n)


def random_flax_params(module, *args, seed, **kwargs):
    """A numpy flax tree of ``module``'s parameter shapes: fan-in-scaled
    normal kernels (activations stay O(1) through the depth and no
    zero-initialised projection hides a path), norm scales near 1, small
    biases."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)
    )
    r = np.random.default_rng(seed)

    def make(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (r.standard_normal(shape) * fan_in**-0.5).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * r.standard_normal(shape)).astype(np.float32)
        if name == "embedding":
            return (0.5 * r.standard_normal(shape)).astype(np.float32)
        return (0.1 * r.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def load_port(module, params, clip=False):
    sd = (clip_state_dict_from_flax if clip else state_dict_from_flax)(params)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, atol=ATOL, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=label)


@pytest.mark.parametrize("path,key", [
    (("down_blocks_0", "resnets_1", "conv1", "kernel"),
     "down_blocks.0.resnets.1.conv1.weight"),
    (("time_embedding", "linear_1", "bias"), "time_embedding.linear_1.bias"),
    (("attn1", "to_out_0", "kernel"), "attn1.to_out.0.weight"),
    (("ff", "net_0", "proj", "kernel"), "ff.net.0.proj.weight"),
    (("norms_1", "scale"), "norms.1.weight"),
    (("layers_3", "mlp_fc2", "bias"), "layers.3.mlp_fc2.bias"),
])
def test_flax_path_to_key(path, key):
    assert flax_path_to_key(path) == key


def test_resnet_block():
    r = np.random.default_rng(0)
    x, temb = randn(r, 1, 3, 8, 8, 8), randn(r, 1, 32)
    jm = jres.ResnetBlock3D(out_channels=16, groups=4)
    params = random_flax_params(jm, x, temb, seed=1)
    want = jm.apply(params, x, temb)
    tm = load_port(tres.ResnetBlock3D(8, 16, 32, groups=4), params)
    close(tm(torch.from_numpy(x), torch.from_numpy(temb)), want)


@pytest.mark.parametrize("linear", [False, True])
def test_transformer3d(linear):
    r = np.random.default_rng(2)
    x, ctx = randn(r, 1, 3, 8, 8, 16), randn(r, 1, 7, 16)
    jm = jattn.Transformer3DModel(
        heads=2, dim_head=8, cross_attention_dim=16, norm_num_groups=4,
        use_linear_projection=linear, attention_impl="xla",
    )
    params = random_flax_params(jm, x, ctx, seed=3)
    want = jm.apply(params, x, ctx)
    tm = load_port(tattn.Transformer3DModel(
        16, 2, 8, cross_attention_dim=16, norm_num_groups=4,
        use_linear_projection=linear), params)
    close(tm(torch.from_numpy(x), torch.from_numpy(ctx)), want)


@pytest.mark.parametrize("return_probs", [False, True])
def test_temporal_module(return_probs):
    r = np.random.default_rng(4)
    x = randn(r, 1, 8, 4, 4, 16)
    jm = jmm.VanillaTemporalModule(
        cfg=jcfg.MotionModuleConfig(num_attention_heads=2, norm_num_groups=4),
        attention_impl="xla",
    )
    params = random_flax_params(jm, x, seed=5)
    want, want_probs = jm.apply(params, x, return_probs=return_probs)
    tm = load_port(tmm.VanillaTemporalModule(
        16, tcfg.MotionModuleConfig(num_attention_heads=2, norm_num_groups=4)), params)
    got, got_probs = tm(torch.from_numpy(x), return_probs=return_probs)
    close(got, want)
    assert len(got_probs) == len(want_probs) == (2 if return_probs else 0)
    for gp, wp in zip(got_probs, want_probs):
        assert gp.shape == (1, 16, 2, 8, 8)
        close(gp, wp, label="probs")


@pytest.fixture(scope="module")
def tiny_unet():
    r = np.random.default_rng(6)
    x, ctx = randn(r, 1, 4, 16, 16, 4), randn(r, 1, 7, 16)
    jm = junet.UNet3DConditionModel(cfg=jcfg.tiny_unet_config(),
                                    guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, x, jnp.zeros((1,), jnp.int32), ctx, seed=7)
    tm = load_port(tunet.UNet3DConditionModel(tcfg.tiny_unet_config()), params)
    return jm, params, tm, x, ctx


@pytest.mark.parametrize("max_up_block", [None, 1])
def test_unet_tiny(tiny_unet, max_up_block):
    """Full forward (noise prediction and guidance probs) and the
    extraction early exit."""
    jm, params, tm, x, ctx = tiny_unet
    apply = jax.jit(jm.apply, static_argnames="max_up_block")
    want, want_probs = apply(params, x, jnp.asarray(401), ctx,
                             max_up_block=max_up_block)
    got, got_probs = tm(torch.from_numpy(x), 401, torch.from_numpy(ctx),
                        guidance_blocks=GUIDANCE, max_up_block=max_up_block)
    if max_up_block is None:
        close(got, want, label="noise_pred")
    else:
        assert got is None and want is None
    assert sorted(got_probs) == sorted(want_probs)
    assert len(got_probs) == 4  # up_blocks.1: 2 motion modules x 2 attn blocks
    for k in got_probs:
        close(got_probs[k], want_probs[k], label=k)


def test_clip_tiny():
    r = np.random.default_rng(8)
    ids = r.integers(0, 64, size=(2, 77)).astype(np.int32)
    jm = jclip.CLIPTextModel(jclip.tiny_clip_config())
    params = random_flax_params(jm, ids, seed=9)
    want = jm.apply(params, ids)
    tm = load_port(tclip.CLIPTextModel(tclip.tiny_clip_config()), params, clip=True)
    close(tm(torch.from_numpy(ids).long()), want)


def test_vae_tiny_encode_decode():
    r = np.random.default_rng(10)
    x = randn(r, 1, 2, 32, 32, 3)
    jm = jvae.AutoencoderKL(jvae.tiny_vae_config())
    params = random_flax_params(jm, x, seed=11)
    (mean_j, logvar_j) = jm.apply(params, x, method=jm.encode)
    dec_j = jm.apply(params, mean_j, method=jm.decode)
    tm = load_port(tvae.AutoencoderKL(tvae.tiny_vae_config()), params)
    mean_t, logvar_t = tm.encode(torch.from_numpy(x), frame_chunk=1)
    close(mean_t, mean_j, label="mean")
    close(logvar_t, logvar_j, label="logvar")
    close(tm.decode(torch.from_numpy(np.array(mean_j)), frame_chunk=1), dec_j,
          label="decode")


def test_yielding_cpu_gives_the_priority_back():
    """Inside ``yielding_cpu`` this thread runs PORT_TEST_NICE nicer, and a
    thread started inside it too; after it, both are back at the process's
    priority."""
    me = threading.get_native_id()
    base = os.getpriority(os.PRIO_PROCESS, me)
    if not _can_restore_priority():
        with yielding_cpu():
            assert os.getpriority(os.PRIO_PROCESS, me) == base
        return
    seen, go, done = {}, threading.Event(), threading.Event()

    def worker():
        seen["tid"] = threading.get_native_id()
        seen["inside"] = os.getpriority(os.PRIO_PROCESS, seen["tid"])
        go.set()
        done.wait(10)

    with yielding_cpu():
        assert os.getpriority(os.PRIO_PROCESS, me) == min(base + PORT_TEST_NICE, 19)
        t = threading.Thread(target=worker)
        t.start()
        go.wait(10)
    assert seen["inside"] == min(base + PORT_TEST_NICE, 19)
    assert os.getpriority(os.PRIO_PROCESS, me) == base
    assert os.getpriority(os.PRIO_PROCESS, seen["tid"]) == base
    done.set()
    t.join()
