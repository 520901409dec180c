"""Frame-sharded sampling of the port vs the JAX package, on the CPU in f32.

* (a) the rectangular temporal attention's plain version (k/v with more
  frames than q), forward, log-sum-exp and VJP, against the JAX Pallas
  kernel in interpret mode at the tile ``pick_tile`` gives, atol 1e-5;
* (b) a ``VanillaTemporalModule`` sharded over 4 ranks (8 frames, 16x16,
  C 16): output and input gradient against the unsharded JAX module, at
  the tolerances of tests/test_parallel.py's rectangular-kernel case;
* (c) the micro UNet's extraction and ``sample`` (2 guided + 1 vanilla
  steps) sharded over 4 ranks (8 frames, 2 per rank) against JAX's
  ``make_sampling_fns(..., frame_shard_map=make_mesh_video(frames=4))`` on
  the 8 virtual CPU devices of conftest.py, and against the port's
  unsharded run: representation values at 2e-5 / 1e-4 and indices equal
  against both, as tests/test_parallel.py holds JAX's own sharded run;
  latents at that test's 2e-4 / 1e-3 against the port's unsharded run, and
  at 2e-3 / 2e-3 against JAX, the tolerance of the port's unsharded
  sampling against JAX's (tests/test_torch_pipeline.py): with these random
  weights the guidance score drives latents to |x| ~ 70, where the two
  frameworks' f32 sums part by ~1e-3;
* (d) the validations, the partial losses, and the launcher's failure path;
* (f) the approx caches under 2 ranks: ``sample`` under step-extrap:2,
  interrupted after the guided chunk and resumed (each rank from its own
  checkpoint), against the port's unsharded run of the same caches, at
  (c)'s tolerance against the unsharded port; and checkpoints a chunk
  apart (a run killed between the ranks' writes) start both ranks again;
* (e) the seed's noise draws: the VAE posterior, the extraction noise and
  the initial latents are pairwise different for one seed and repeat for
  the same seed, and each launched gloo rank's initial latents are its
  frames of the unsharded draw.

The ranks are gloo processes on the CPU (``parallel.frames.launch``, with a
time limit); their bodies live in test_torch_frame_shard_ranks.py, which
imports no JAX.  One launch serves (b), (c) and (d)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from motionclone_tpu import config as jcfg
from motionclone_tpu.models.motion_module import VanillaTemporalModule as JModule
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.ops.temporal_attention import (
    _temporal_fwd,
    pick_tile,
    temporal_attention as jax_temporal,
)
from motionclone_tpu.parallel.mesh import make_mesh_video, shard_params
from motionclone_tpu.pipeline.motionclone import make_sampling_fns as j_make_fns
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models.motion_module import VersatileAttention
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.ops import temporal_attention as ta
from motionclone_tpu_torch.parallel.frames import FrameGroup, launch
from motionclone_tpu_torch.pipeline.motionclone import (
    MotionClonePipeline,
    make_sampling_fns as t_make_fns,
)
from motionclone_tpu_torch.utils import rng as trng
from motionclone_tpu_torch.weights.from_jax import state_dict_from_flax
from test_torch_frame_shard_ranks import approx_resume_rank, failing_rank, frame_shard_rank
from test_torch_models import load_port, one_torch_thread, random_flax_params  # noqa: F401

RANKS = 4
LAUNCH_TIMEOUT_S = 240.0
GUIDANCE = ("up_blocks.1",)
F_, HW = 8, 16  # frames and latent side of (b) and (c): 2 frames per rank
DRAW_SEED = 7  # the seed of the ranks' initial latents in (e)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# (a) the rectangular form against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f,s", [(2, 64), (4, 128)])
def test_rect_plain_matches_jax_kernel(f, s):
    b, fk, heads, d = 2, 8, 2, 8
    ts = pick_tile(f, s)
    rng = np.random.default_rng(f + s)
    q, cot = (rng.standard_normal((b, f, s, heads * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, fk, s, heads * d)).astype(np.float32) for _ in range(2))
    scale = d**-0.5
    out_j, lse_j = _temporal_fwd(*(jnp.asarray(x) for x in (q, k, v)), scale, ts, heads)
    out_t, lse_t = ta.temporal_attention_plain(_t(q), _t(k), _t(v), heads, scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-4)
    # JAX lse: (B, S/ts, heads, f*ts) with row f_i*ts + s; the port's (B, S, heads, f)
    lse_j = np.asarray(lse_j).reshape(b, s // ts, heads, f, ts)
    lse_j = lse_j.transpose(0, 1, 4, 2, 3).reshape(b, s, heads, f)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-5, rtol=1e-4)

    _, vjp = jax.vjp(lambda a, bb, c: jax_temporal(a, bb, c, heads=heads, scale=scale, ts=ts),
                     *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(cot))
    grads_t = ta.temporal_attention_bwd_plain(_t(q), _t(k), _t(v), _t(cot), heads, scale)
    for gt, gj, x, name in zip(grads_t, grads_j, (q, k, v), "qkv"):
        assert gt.shape == x.shape, name
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")
    # the differentiable entry point takes the same route on CPU tensors
    qq, kk, vv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = ta.temporal_attention(qq, kk, vv, heads=heads, scale=scale)
    np.testing.assert_array_equal(out.detach().numpy(), out_t.numpy())
    for g, gt in zip(torch.autograd.grad(out, (qq, kk, vv), _t(cot)), grads_t):
        np.testing.assert_allclose(g.numpy(), gt.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# one launch of 4 ranks for (b), (c) and (d)
# ---------------------------------------------------------------------------


def _module_cfg(mod):
    return mod.MotionModuleConfig(
        num_attention_heads=2, num_transformer_block=1,
        attention_block_types=("Temporal_Self", "Temporal_Self"),
        temporal_position_encoding=True, temporal_position_encoding_max_len=24,
        norm_num_groups=4,
    )


def _infer(mod):
    # tests/test_parallel.py's schedule: 3 steps, 2 guided
    return mod.InferenceConfig(
        inference_steps=3, guidance_steps=2, guidance_fraction=0.3,
        warm_up_steps=1, cool_up_steps=1, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400, cfg_scale=7.5,
        width=HW * 8, height=HW * 8, video_length=F_,
    )


@pytest.fixture(scope="module")
def sharded():
    """Inputs and weights made with numpy, the 4 ranks' results, and the
    port's unsharded pipeline on the same inputs."""
    rng = np.random.default_rng(8)
    # (b): tests/test_parallel.py's module, its parameters + 0.05
    x = rng.standard_normal((1, F_, HW, HW, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jmod = JModule(cfg=_module_cfg(jcfg))
    mparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # (c): the micro UNet
    shape = (1, F_, HW, HW, 4)
    video_latents, noise, init = (rng.standard_normal(shape).astype(np.float32)
                                  for _ in range(3))
    uncond, cond = (rng.standard_normal((1, 7, 16)).astype(np.float32) for _ in range(2))
    jm = JUNet(cfg=jcfg.micro_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, video_latents, jnp.zeros((1,), jnp.int32), uncond,
                                seed=9)
    module_case = dict(state_dict=state_dict_from_flax(mparams), cfg=_module_cfg(tcfg),
                       x=_t(x), w=_t(w))
    pipeline_case = dict(
        state_dict=state_dict_from_flax(params), unet_cfg=tcfg.micro_unet_config(),
        sched_cfg=tcfg.NoiseScheduleConfig(), infer_cfg=_infer(tcfg),
        video_latents=_t(video_latents), noise=_t(noise), init=_t(init),
        uncond=_t(uncond), cond=_t(cond), draw_seed=DRAW_SEED,
    )
    results = launch(frame_shard_rank, RANKS, backend="gloo",
                     args=(module_case, pipeline_case), timeout=LAUNCH_TIMEOUT_S)

    unet = load_port(TUNet(tcfg.micro_unet_config()), params)
    fns = t_make_fns(unet, tcfg.NoiseScheduleConfig(), _infer(tcfg))
    rep = fns.extract(_t(video_latents), _t(noise), _t(uncond))
    t, tp = (int(v) for v in fns.timesteps[:2])
    return dict(
        results=results, x=x, w=w, jmod=jmod, mparams=mparams, params=params,
        video_latents=video_latents, noise=noise, init=init, uncond=uncond, cond=cond,
        unet=unet, rep=rep,
        latents=fns.sample(_t(init), _t(uncond), _t(cond), rep),
        loss=float(fns.guided_step(_t(init), t, tp, 1.0, _t(uncond), _t(cond), rep)[1]),
    )


def test_sharded_temporal_module_matches_jax(sharded):
    """(b): all_gathered K/V, the rectangular attention and the gather's
    transpose reproduce the unsharded module's output and input gradient;
    every rank ends with the same gathered tensors."""
    s = sharded
    ref = s["jmod"].apply(s["mparams"], jnp.asarray(s["x"]))[0]
    g_ref = jax.grad(lambda xs: jnp.sum(jnp.asarray(s["w"]) * s["jmod"].apply(
        s["mparams"], xs)[0]))(jnp.asarray(s["x"]))
    for r, res in enumerate(s["results"]):
        np.testing.assert_allclose(res["module"]["out"].numpy(), np.asarray(ref),
                                   atol=3e-5, rtol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["module"]["grad"].numpy(), np.asarray(g_ref),
                                   atol=5e-5, rtol=1e-4, err_msg=f"rank {r}")


def test_sharded_pipeline_matches_jax_shard_map(sharded):
    """(c): extraction and sampling against JAX's frame_shard_map run."""
    s = sharded
    mesh = make_mesh_video(frames=RANKS)
    fsh = NamedSharding(mesh, P(None, "frames"))
    fns = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                     dtype=jnp.float32, attention_impl="xla", frame_shard_map=mesh)
    p = shard_params(s["params"], mesh)
    with mesh:
        rep_j = fns.extract(p, jax.device_put(s["video_latents"], fsh),
                            jax.device_put(s["noise"], fsh), s["uncond"], None, None)
        want = fns.sample(p, jax.device_put(s["init"], fsh), s["uncond"], s["cond"],
                          rep_j, None, None)
    got = s["results"][0]["pipeline"]
    assert sorted(got["rep"]) == sorted(rep_j) and len(rep_j) == 4
    for k, (vals, idx) in got["rep"].items():
        np.testing.assert_allclose(vals.numpy(), np.asarray(rep_j[k][0]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
        assert idx.dtype == torch.uint8
        np.testing.assert_array_equal(idx.numpy(), np.asarray(rep_j[k][1]), err_msg=k)
    np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


def test_sharded_pipeline_matches_unsharded_port(sharded):
    """(c): every rank's gathered representation and latents equal the
    port's unsharded run."""
    s = sharded
    for r, res in enumerate(s["results"]):
        got = res["pipeline"]
        for k, (vals, idx) in s["rep"].items():
            np.testing.assert_allclose(got["rep"][k][0].numpy(), vals.numpy(),
                                       atol=2e-5, rtol=1e-4, err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(got["rep"][k][1].numpy(), idx.numpy(),
                                          err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["latents"].numpy(), s["latents"].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=f"rank {r}")


@pytest.fixture(scope="module")
def approx_ranks(sharded, tmp_path_factory):
    """(f)'s one launch of 2 ranks (test_torch_frame_shard_ranks.py's
    ``approx_resume_rank``) and its work directory."""
    s = sharded
    workdir = tmp_path_factory.mktemp("approx")
    args = (state_dict_from_flax(s["params"]), tcfg.micro_unet_config(),
            tcfg.NoiseScheduleConfig(), _infer(tcfg), _t(s["video_latents"]), _t(s["noise"]),
            _t(s["init"]), _t(s["uncond"]), _t(s["cond"]), str(workdir))
    results = launch(approx_resume_rank, 2, backend="gloo", args=args,
                     timeout=LAUNCH_TIMEOUT_S)
    return results, workdir


def test_sharded_approx_resume_matches_unsharded_port(sharded, approx_ranks):
    """(f): 2 ranks, step-extrap:2, each interrupted after the guided
    chunk and resumed from its own checkpoint, against the unsharded run
    of the same caches."""
    s = sharded
    results, workdir = approx_ranks
    fns = t_make_fns(s["unet"], tcfg.NoiseScheduleConfig(), _infer(tcfg), step_interval=2,
                     step_extrap=1.0)
    assert fns.schedule().full.tolist() == [True, False, True]
    want = fns.sample(_t(s["init"]), _t(s["uncond"]), _t(s["cond"]), s["rep"])
    assert not torch.equal(want, s["latents"])
    for r, res in enumerate(results):
        assert res["left"] == ["run.npz.rank0.npz", "run.npz.rank1.npz"]
        np.testing.assert_allclose(res["latents"].numpy(), want.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"rank {r}")
    assert not os.listdir(workdir)


def test_sharded_resume_restarts_when_ranks_disagree(approx_ranks):
    """(f): a run killed between the ranks' checkpoint writes leaves rank
    1's file one chunk behind rank 0's; each rank holds only its last
    checkpoint, so the rerun starts both ranks again from step 0 (rather
    than at different chunks, whose gathers would not match) and ends on
    the uninterrupted run's latents."""
    results, _ = approx_ranks
    for r, res in enumerate(results):
        assert res["behind_done"] == [2, 1], f"rank {r}"
        assert res["behind_steps"] == [0, 1, 2], f"rank {r}"
        assert res["behind_equal"], f"rank {r}"


def test_partial_losses_sum_to_the_unsharded_loss(sharded):
    """(d): each rank's partial is its local sum over the global count; the
    partials sum to the unsharded loss, which ``guided_step`` returns on
    every rank."""
    s = sharded
    partials = [res["pipeline"]["partial_loss"] for res in s["results"]]
    assert len(set(partials)) > 1  # each rank holds a different share
    np.testing.assert_allclose(sum(partials), s["loss"], rtol=1e-5)
    for res in s["results"]:
        np.testing.assert_allclose(res["pipeline"]["loss"], s["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) validations, in this process: none of them reaches a collective
# ---------------------------------------------------------------------------


def _micro_unet(**overrides):
    torch.manual_seed(0)
    return TUNet(dataclasses.replace(tcfg.micro_unet_config(), **overrides)).eval()


def test_sharding_refuses_per_video_groupnorm():
    with pytest.raises(ValueError, match="inflated"):
        t_make_fns(_micro_unet(use_inflated_groupnorm=False), tcfg.NoiseScheduleConfig(),
                   _infer(tcfg), frame_group=FrameGroup(0, RANKS, "gloo"))


def test_sharding_refuses_a_size_that_does_not_divide_the_video():
    with pytest.raises(ValueError, match="does not split"):
        t_make_fns(_micro_unet(), tcfg.NoiseScheduleConfig(), _infer(tcfg),
                   frame_group=FrameGroup(0, 3, "gloo"))


def test_group_of_one_runs_unsharded():
    unet = _micro_unet()
    for p in unet.parameters():  # no zero-initialised projection
        torch.nn.init.normal_(p, 0.0, 0.2)
    r = np.random.default_rng(3)
    lat, noise, init = (_t(r.standard_normal((1, F_, HW, HW, 4)).astype(np.float32))
                        for _ in range(3))
    uncond, cond = (_t(r.standard_normal((1, 7, 16)).astype(np.float32)) for _ in range(2))
    outs = []
    for group in (None, FrameGroup(0, 1, "gloo")):
        fns = t_make_fns(unet, tcfg.NoiseScheduleConfig(), _infer(tcfg), frame_group=group)
        assert fns.frame_group is None
        rep = fns.extract(lat, noise, uncond)
        outs.append(fns.sample(init, uncond, cond, rep))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


def test_positional_encoding_must_hold_the_global_video():
    """A rank of 2 frames in a group of 4 needs 8 rows of the table; the
    check comes before any gather."""
    attn = VersatileAttention(16, 2, 8, pos_encoding_max_len=6)
    with pytest.raises(ValueError, match="video_length 8"):
        attn(torch.zeros(1, 2, 4, 16), frame_group=FrameGroup(0, RANKS, "gloo"))


def test_local_frames_are_the_ranks_share():
    x = torch.arange(2 * 8).reshape(2, 8)
    parts = [FrameGroup(r, 4, "gloo").local_frames(x) for r in range(4)]
    torch.testing.assert_close(torch.cat(parts, dim=1), x)
    with pytest.raises(ValueError, match="do not split"):
        FrameGroup(0, 3, "gloo").local_frames(x)


def test_from_env_joins_the_group_torchrun_describes(monkeypatch):
    """torchrun's variables, a group of one on a localhost port: the group
    gathers and sums as the identity."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    group = FrameGroup.from_env(backend="gloo", timeout=60)
    try:
        assert (group.rank, group.size, group.backend) == (0, 1, "gloo")
        x = torch.arange(6.0).reshape(1, 6)
        torch.testing.assert_close(group.gather_frames(x), x)
        torch.testing.assert_close(group.all_reduce_sum(x), x)
    finally:
        torch.distributed.destroy_process_group()


def test_launch_reports_a_failing_rank_without_waiting():
    """Rank 1 raises while rank 0 waits in a gather: the launcher raises
    with rank 1's traceback and stops rank 0 long before the time limit."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(failing_rank, 2, backend="gloo", timeout=LAUNCH_TIMEOUT_S)


# ---------------------------------------------------------------------------
# (e) the seed's three noise draws
# ---------------------------------------------------------------------------


def _draw_pipeline(frame_group=None):
    from motionclone_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config

    torch.manual_seed(0)
    return MotionClonePipeline(tcfg.micro_unet_config(), tcfg.NoiseScheduleConfig(),
                               _infer(tcfg), TUNet(tcfg.micro_unet_config()),
                               vae=AutoencoderKL(tiny_vae_config()), device="cpu",
                               dtype=torch.float32, frame_group=frame_group)


def test_seed_draws_are_domain_separated_and_repeat(monkeypatch):
    """One seed through encode_video, extraction and the initial latents:
    three draws of shape (1, F, h, w, 4), pairwise different; the same seed
    gives the same three again, another seed three others."""
    drawn = []
    draw = trng.draw_normal
    monkeypatch.setattr(trng, "draw_normal",
                        lambda *a: drawn.append((a[2], draw(*a))) or drawn[-1][1])
    pipe = _draw_pipeline()
    video = torch.rand(F_, 2 * HW, 2 * HW, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    empty = torch.zeros(1, 7, 16)

    def draws(seed):
        drawn.clear()
        latents = pipe.encode_video(video, seed)
        pipe.extract_motion_representation(latents, empty, seed)
        pipe.initial_latents(seed)
        return dict(drawn)

    first = draws(2025)
    assert sorted(first) == [trng.VAE_POSTERIOR, trng.EXTRACT_NOISE, trng.INIT_LATENTS]
    tensors = list(first.values())
    assert all(t.shape == (1, F_, HW, HW, 4) for t in tensors)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.allclose(tensors[i], tensors[j])
    again, other = draws(2025), draws(2026)
    for domain, t in first.items():
        assert torch.equal(again[domain], t)
        assert not torch.allclose(other[domain], t)


def test_each_rank_draws_its_frames_of_the_global_noise(sharded):
    """Each of the launched ranks (torch's global generator seeded with the
    rank) draws, for one seed, exactly its frames of the unsharded draw."""
    whole = _draw_pipeline().initial_latents(DRAW_SEED)
    parts = [res["pipeline"]["initial_latents"] for res in sharded["results"]]
    assert len(parts) == RANKS
    assert all(p.shape == (1, F_ // RANKS, HW, HW, 4) for p in parts)
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0, atol=0)
