"""The port's approx caches, chunked ``sample``, resume and weights cache,
on the CPU in f32.

* ``sample`` under the caches against the JAX package's: the tiny UNet3D
  (4 frames, 8x8 latents, 12 steps of which 6 guided, cfg 7.5) with
  random fan-in-scaled flax parameters carried into the port by
  ``weights/from_jax.py``, both built with every cache on and run with
  ``chunk_steps=3`` (two chunks per phase) at four (K_u, K_g, K_s, w_u,
  w_s) points given as run-time overrides, so that JAX compiles once;
  tolerance 2e-3, that of tests/test_torch_pipeline.py's exact slice;
* port-only: the exact ``sample`` and every override at 1 are the exact
  steps driven one at a time, bit for bit; at
  cfg_scale 0 the uncond cache is exact; chunking changes an approx run
  and leaves the exact one alone; the controlnet runs once per full step;
  the refresh flags, the guards and ``parse_approx`` equal JAX's;
* resume: an interrupted and resumed run equals an uninterrupted one bit
  for bit, a checkpoint of another run is ignored, one the JAX package
  wrote is taken;
* the weights cache's file format and key (the runtime's cold and warm
  loads are in tests/test_torch_runtime.py, on its model directory)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import cli as jcli
from motionclone_tpu import config as jcfg
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.pipeline import motionclone as jmc
from motionclone_tpu_torch import cli as tcli
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models import sparse_controlnet as tsc
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.pipeline import motionclone as tmc
from motionclone_tpu_torch.weights import cache as wcache
from motionclone_tpu_torch.weights.io import load_safetensors, save_safetensors
from test_sparse_controlnet import tiny_cn_config
from test_torch_models import load_port, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_sparse_controlnet import _port_cfg

B, F_, HW = 1, 4, 8
GUIDANCE = ("up_blocks.1",)
CHUNK = 3
BUILD = dict(uncond_interval=2, guidance_interval=2, uncond_extrap=1.0, step_interval=2,
             step_extrap=1.0)
# (K_u, K_g, K_s, w_u, w_s)
POINTS = [(2, 1, 1, 0.0, 0.0), (3, 2, 1, 1.0, 0.0), (2, 2, 2, 1.0, 1.0), (1, 1, 3, 0.0, 1.0)]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def _overrides(point, chunk_steps=CHUNK):
    k_u, k_g, k_s, w_u, w_s = point
    return dict(chunk_steps=chunk_steps, uncond_refresh=k_u, guidance_refresh=k_g,
                step_refresh=k_s, uncond_extrap_w=w_u, step_extrap_w=w_s)


def _infer(mod, **kw):
    return mod.InferenceConfig(**dict(dict(
        inference_steps=12, guidance_steps=6, guidance_fraction=0.3, warm_up_steps=1,
        cool_up_steps=1, motion_guidance_weight=50.0, motion_guidance_blocks=GUIDANCE,
        add_noise_step=400, cfg_scale=7.5, width=HW * 8, height=HW * 8, video_length=F_),
        **kw))


@pytest.fixture(scope="module")
def s():
    """One JAX build with every cache on (compiled once, by its first
    ``sample``), the port's builds on the same weights, and the inputs."""
    r = np.random.default_rng(50)
    shape = (B, F_, HW, HW, 4)
    video, noise, init = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    uncond, cond = (r.standard_normal((1, 7, 16)).astype(np.float32) for _ in range(2))
    jm = JUNet(cfg=jcfg.tiny_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, init, jnp.zeros((1,), jnp.int32), uncond, seed=51)
    unet = load_port(TUNet(tcfg.tiny_unet_config()), params)
    sched = tcfg.NoiseScheduleConfig()
    exact = tmc.make_sampling_fns(unet, sched, _infer(tcfg))
    approx = tmc.make_sampling_fns(unet, sched, _infer(tcfg), **BUILD)
    rep = exact.extract(_t(video), _t(noise), _t(uncond))
    fns_j = jmc.make_sampling_fns(jcfg.tiny_unet_config(), jcfg.NoiseScheduleConfig(),
                                  _infer(jcfg), dtype=jnp.float32, attention_impl="xla",
                                  **BUILD)
    args = (_t(init), _t(uncond), _t(cond), rep)
    return dict(params=params, unet=unet, exact=exact, approx=approx, fns_j=fns_j,
                init=init, uncond=uncond, cond=cond, rep=rep,
                rep_j={k: (v.numpy(), i.numpy()) for k, (v, i) in rep.items()},
                args=args, exact_out=exact.sample(*args))


def _jax_sample(s, **kw):
    return np.asarray(s["fns_j"].sample(s["params"], s["init"], s["uncond"], s["cond"],
                                        s["rep_j"], None, None, **kw))


# ---------------------------------------------------------------------------
# the caches against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", POINTS, ids=lambda p: "Ku{}-Kg{}-Ks{}-wu{}-ws{}".format(*p))
def test_approx_sample_matches_jax(s, point):
    want = _jax_sample(s, **_overrides(point))
    got = s["approx"].sample(*s["args"], **_overrides(point))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    # it is an approximation: the exact run differs
    assert (got - s["exact_out"]).abs().max() > 1e-2


def test_refresh_flags_equal_jax():
    for n in (1, 3, 7, 12):
        for k in (1, 2, 3, 5):
            for executed in (None, np.arange(n) % 2 == 0, np.arange(n) % 3 == 0,
                             np.random.default_rng(n + k).random(n) < 0.6):
                np.testing.assert_array_equal(tmc._refresh_flags(n, k, executed),
                                              np.asarray(jmc._refresh_flags(n, k, executed)))
    np.testing.assert_array_equal(tmc._const_col(4, 0.5), np.asarray(jmc._const_col(4, 0.5)))


def test_schedule_counts_executed_steps(s):
    """Under step-extrap:2 with uncond-cache:2 the uncond forward is fresh
    on every other executed step, and every chunk starts with a full,
    fresh step."""
    sched = s["approx"].schedule(chunk_steps=CHUNK, uncond_refresh=2, guidance_refresh=3,
                                 step_refresh=2)
    full = [True, False, True] * 4
    assert sched.full.tolist() == full
    assert sched.uncond.tolist() == [True, False, False] * 4
    assert sched.guidance.tolist() == [True, False, False] * 2 + [True] * 6
    assert s["exact"].schedule().full.all() and s["exact"].schedule().uncond.all()


# ---------------------------------------------------------------------------
# port-only identities
# ---------------------------------------------------------------------------


def _chip_smoke():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_every_override_at_one_is_the_exact_sample(s):
    """``sample`` runs the exact schedule through the cached steps with
    every flag true: the exact build's run and the approx build's with
    every override at 1 both equal the exact steps driven one at a time
    (chip_smoke.py's ``stepped_sample``, the same check as its phase
    9(e))."""
    want = _chip_smoke().stepped_sample(s["exact"], _infer(tcfg), *s["args"])
    torch.testing.assert_close(s["exact_out"], want, rtol=0, atol=0)
    got = s["approx"].sample(*s["args"], **_overrides((1, 1, 1, 1.0, 1.0)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("guided_only", [True, False])
def test_uncond_cache_is_exact_at_zero_cfg_scale(s, guided_only):
    """cfg_scale 0 takes the uncond prediction out of the CFG formula, so
    the held or extrapolated uncond prediction cannot move the result: bit
    for bit where every step is guided (the conditional pass is the exact
    step's); with vanilla steps within tests/test_approx.py's tolerance,
    because a stale vanilla step's conditional forward is a batch of 1
    where the exact step's is the CFG pair's batch of 2, which rounds
    otherwise."""
    sched = tcfg.NoiseScheduleConfig()
    infer = _infer(tcfg, cfg_scale=0.0, **(dict(inference_steps=6) if guided_only else {}))
    want = tmc.make_sampling_fns(s["unet"], sched, infer).sample(*s["args"])
    # held where every step is guided, extrapolated with vanilla steps
    fns = tmc.make_sampling_fns(s["unet"], sched, infer, uncond_interval=3,
                                uncond_extrap=0.0 if guided_only else 1.0)
    got = fns.sample(*s["args"], chunk_steps=CHUNK)
    if guided_only:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


def test_chunks_move_an_approx_run_and_not_the_exact_one(s):
    exact = s["exact"].sample(*s["args"], chunk_steps=CHUNK)
    torch.testing.assert_close(exact, s["exact_out"], rtol=0, atol=0)  # chunks of 50
    point = (2, 2, 2, 1.0, 1.0)
    approx = [s["approx"].sample(*s["args"], **_overrides(point, c)) for c in (CHUNK, 50)]
    assert (approx[0] - approx[1]).abs().max() > 1e-3


def test_controlnet_runs_once_per_full_step(s):
    """The controlnet pass on the CFG pair is part of a full step's model
    work (stale uncond and stale guidance steps included) and of no skip
    step's."""
    torch.manual_seed(5)
    cn = tsc.SparseControlNetModel(_port_cfg(tiny_cn_config(simplified=True))).eval()
    for p in cn.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    fns = tmc.make_sampling_fns(s["unet"], tcfg.NoiseScheduleConfig(), _infer(tcfg),
                                controlnet=cn, **BUILD)
    r = np.random.default_rng(6)
    cond, mask = tsc.scatter_condition(
        _t(r.standard_normal((B, 1, HW, HW, 4)).astype(np.float32)), (1,), F_)
    calls = []
    forward = cn.forward
    cn.forward = lambda *a, **k: calls.append(a[0].shape[0]) or forward(*a, **k)
    fns.sample(*s["args"], cn_cond=(cond, mask, 0.5), **_overrides((2, 2, 2, 1.0, 1.0)))
    sched = fns.schedule(chunk_steps=CHUNK, uncond_refresh=2, guidance_refresh=2,
                         step_refresh=2)
    assert calls == [2] * int(sched.full.sum()) and sched.full.sum() == 8
    assert (~sched.uncond & sched.full).any()  # stale uncond steps ran it too


BUILD_GUARDS = [dict(uncond_interval=0), dict(guidance_interval=0), dict(step_interval=0),
                dict(uncond_extrap=0.5), dict(step_extrap=0.5)]
SAMPLE_GUARDS = [("exact", dict(uncond_refresh=2)), ("exact", dict(guidance_refresh=2)),
                 ("exact", dict(step_refresh=2)), ("exact", dict(uncond_extrap_w=0.5)),
                 ("exact", dict(step_extrap_w=0.5)), ("approx", dict(uncond_refresh=0)),
                 ("approx", dict(guidance_refresh=0)), ("approx", dict(step_refresh=0))]


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_guards_raise_jax_messages(s):
    sched_j, sched_t = jcfg.NoiseScheduleConfig(), tcfg.NoiseScheduleConfig()
    for kw in BUILD_GUARDS:
        want = _message(lambda: jmc.make_sampling_fns(
            jcfg.tiny_unet_config(), sched_j, _infer(jcfg), dtype=jnp.float32,
            attention_impl="xla", **kw))
        assert _message(lambda: tmc.make_sampling_fns(s["unet"], sched_t, _infer(tcfg),
                                                      **kw)) == want
    j_exact = jmc.make_sampling_fns(jcfg.tiny_unet_config(), sched_j, _infer(jcfg),
                                    dtype=jnp.float32, attention_impl="xla")
    for build, kw in SAMPLE_GUARDS:
        fns_j = j_exact if build == "exact" else s["fns_j"]
        want = _message(lambda: fns_j.sample(s["params"], s["init"], s["uncond"], s["cond"],
                                             s["rep_j"], None, None, **kw))
        assert _message(lambda: s[build].sample(*s["args"], **kw)) == want


APPROX_SPECS = ["", "uncond-cache", "uncond-cache:4", "uncond-extrap", "guidance-cache",
                "step-cache", "step-extrap", "step-extrap:3", " step-extrap:5 ",
                "uncond-extrap:3,guidance-cache:2", "guidance-cache:3,step-extrap:2",
                "uncond-cache:2,step-cache:4", "bogus", "step-cache:1", "uncond-cache:0",
                "uncond-cache,uncond-extrap", "step-cache:2,step-extrap:3"]


def test_parse_approx_equals_jax():
    for spec in APPROX_SPECS:
        try:
            want = jcli.parse_approx(spec)
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                tcli.parse_approx(spec)
            assert str(got.value) == str(e), spec
        else:
            assert tcli.parse_approx(spec) == want, spec


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

RESUME_POINT = (2, 2, 2, 1.0, 1.0)


class _Stop(Exception):
    pass


def _stop_after(steps):
    def on_chunk(done, total):
        assert total == 12
        if done == steps:
            raise _Stop
    return on_chunk


@pytest.fixture(scope="module")
def uninterrupted(s):
    return s["approx"].sample(*s["args"], **_overrides(RESUME_POINT))


def test_resume_continues_an_interrupted_run_bit_for_bit(s, uninterrupted, tmp_path):
    path = str(tmp_path / "run.npz")
    kw = _overrides(RESUME_POINT)
    with pytest.raises(_Stop):
        s["approx"].sample(*s["args"], resume_path=path, on_chunk=_stop_after(CHUNK), **kw)
    with np.load(path) as d:
        assert sorted(d.files) == ["chunk_steps", "latents", "steps_done", "tag", "timesteps"]
        assert int(d["steps_done"]) == CHUNK and d["latents"].dtype == np.float32
    steps, chunks = [], []
    got = s["approx"].sample(*s["args"], resume_path=path, on_chunk=lambda *a: chunks.append(a),
                             on_step=lambda i, g: steps.append((i, g)), **kw)
    assert steps == [(i, i < 6) for i in range(CHUNK, 12)]
    assert chunks == [(6, 12), (9, 12), (12, 12)]
    torch.testing.assert_close(got, uninterrupted, rtol=0, atol=0)
    assert not os.path.exists(path)


@pytest.mark.parametrize("field", ["chunk_steps", "tag", "timesteps", "shape"])
def test_resume_ignores_another_runs_checkpoint(s, tmp_path, field):
    path = str(tmp_path / "other.npz")
    record = dict(latents=np.zeros((B, F_, HW, HW, 4), np.float32), steps_done=6,
                  timesteps=np.asarray(s["approx"].timesteps, np.int32), chunk_steps=CHUNK,
                  tag="")
    record.update({"chunk_steps": dict(chunk_steps=4), "tag": dict(tag="other"),
                   "timesteps": dict(timesteps=record["timesteps"][::-1].copy()),
                   "shape": dict(latents=np.zeros((B, F_, HW, 2 * HW, 4), np.float32))}[field])
    np.savez(path, **record)
    steps = []

    def first_step(i, guided):  # the run starts at step 0: the file was not taken
        steps.append(i)
        raise _Stop

    with pytest.raises(_Stop):
        s["approx"].sample(*s["args"], resume_path=path, on_step=first_step,
                           **_overrides(RESUME_POINT))
    assert steps == [0]


def test_resume_takes_a_jax_checkpoint(s, tmp_path):
    """A checkpoint that the JAX package's ``sample`` wrote after its first
    chunk: the port continues from it and lands on JAX's uninterrupted run
    (within the parity tolerance)."""
    path = str(tmp_path / "jax.npz")
    kw = _overrides(RESUME_POINT)
    with pytest.raises(_Stop):
        _jax_sample(s, resume_path=path, on_chunk=_stop_after(CHUNK), **kw)
    want = _jax_sample(s, **kw)
    steps = []
    got = s["approx"].sample(*s["args"], resume_path=path, on_step=lambda i, g: steps.append(i),
                             **kw)
    assert steps == list(range(CHUNK, 12))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def test_resume_keeps_each_ranks_frames_apart(s, tmp_path):
    """Under a frame group a rank's checkpoint is its own file
    (``<path>.rank<r>.npz``); a group of one runs unsharded, on the path
    itself."""
    from motionclone_tpu_torch.parallel.frames import FrameGroup

    fns = tmc.make_sampling_fns(s["unet"], tcfg.NoiseScheduleConfig(), _infer(tcfg),
                                frame_group=FrameGroup(0, 1, "gloo"), **BUILD)
    path = str(tmp_path / "one.npz")
    with pytest.raises(_Stop):
        fns.sample(*s["args"], resume_path=path, on_chunk=_stop_after(CHUNK), chunk_steps=CHUNK)
    assert os.listdir(tmp_path) == ["one.npz"]


# ---------------------------------------------------------------------------
# the weights cache's file and key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64])
def test_save_safetensors_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    tensors = {
        "a.weight": torch.randn(3, 5, generator=g),
        "b": torch.randn(7, generator=g),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
        "odd": torch.randn(1, 3, 3, generator=g) * 1e3,
    }
    tensors = {k: v.to(dtype) for k, v in tensors.items()}
    tensors["mask"] = torch.tensor([True, False, True])  # a 1-byte dtype beside
    tensors["t"] = torch.randn(4, 6, generator=g).t()  # not contiguous
    path = str(tmp_path / "x.safetensors")
    save_safetensors(path, tensors)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0
    got = load_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
        if v.dtype == torch.bfloat16:  # the bits, not only the values
            assert torch.equal(got[k].view(torch.int16), v.view(torch.int16))


def test_cache_key_misses_on_every_input(tmp_path, monkeypatch):
    src = tmp_path / "unet.bin"
    src.write_bytes(b"12345678")
    knobs = {"dtype": "bfloat16", "adapter_lora_scale": 1.0}
    key = wcache.cache_key([str(src), ""], knobs)
    assert wcache.cache_key([str(src), ""], dict(knobs)) == key
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    key_mtime = wcache.cache_key([str(src), ""], knobs)
    src.write_bytes(b"123456789")
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    keys = [key, key_mtime, wcache.cache_key([str(src), ""], knobs),
            wcache.cache_key([str(src), ""], dict(knobs, dtype="float32")),
            wcache.cache_key([str(src), ""], dict(knobs, adapter_lora_scale=0.5)),
            wcache.cache_key([str(src), str(tmp_path / "absent")], knobs)]
    monkeypatch.setattr(wcache, "_converter_fingerprint", lambda: [["convert.py", 1, 2]])
    keys.append(wcache.cache_key([str(src), ""], knobs))
    assert len(set(keys)) == len(keys)


def test_cache_entries_save_load_and_miss(tmp_path):
    d = str(tmp_path / "wc")
    sds = {"unet": {"conv.weight": torch.randn(4, 3).to(torch.bfloat16)},
           "vae": {"b": torch.arange(5, dtype=torch.float32)}, "controlnet": None}
    assert wcache.load_params(d, "k1") is None
    path = wcache.save_params(d, "k1", sds)
    assert os.path.basename(path) == "params-torch-k1.safetensors"
    # an orphan of a crashed write is swept once it is an hour old
    orphan = os.path.join(d, "params-torch-k0.safetensors.tmp.123")
    with open(orphan, "wb") as f:
        f.write(b"x")
    os.utime(orphan, (0, 0))
    wcache.save_params(d, "k2", sds)
    assert sorted(os.listdir(d)) == ["params-torch-k1.safetensors",
                                     "params-torch-k2.safetensors"]
    got = wcache.load_params(d, "k1")
    assert sorted(got) == ["unet", "vae"]
    for comp in got:
        for k, v in sds[comp].items():
            assert torch.equal(got[comp][k], v)
    # a corrupt or truncated entry is a miss
    with open(path, "rb") as f:
        blob = f.read()
    for bad in (b"not a safetensors file", blob[:-3], blob[:20]):
        with open(path, "wb") as f:
            f.write(bad)
        assert wcache.load_params(d, "k1") is None


def test_chip_smoke_predicts_approx_launches_from_the_flags():
    """chip_smoke.py's ``predicted_launches`` on configs/t2v_camera.yaml's
    schedule (100 steps, 50 guided, one chunk per phase): the exact path
    gives PREDICTED_LAUNCHES' (and PREDICTED_I2V_LAUNCHES' with the
    controlnet); step-extrap:3 runs 17 full steps per phase and nothing on
    the 66 others; uncond-extrap:3,guidance-cache:2 runs 17 uncond
    forwards, 25 guidance passes and 25 plain conditional forwards in the
    guided phase and one plain forward per vanilla step."""
    cs = _chip_smoke()
    infer = tcfg.load_inference_config(
        os.path.join(os.path.dirname(cs.__file__), "configs", "t2v_camera.yaml"))
    assert (infer.inference_steps, infer.guidance_steps) == (100, 50)
    torch.manual_seed(0)
    unet = TUNet(tcfg.micro_unet_config())
    fns = tmc.make_sampling_fns(unet, tcfg.NoiseScheduleConfig(), infer, **BUILD)
    exact = fns.schedule(uncond_refresh=1, guidance_refresh=1, step_refresh=1)
    step = fns.schedule(uncond_refresh=1, guidance_refresh=1, step_refresh=3)
    finer = fns.schedule(uncond_refresh=3, guidance_refresh=2, step_refresh=1)
    for name, (ext, per_g, per_v) in cs.PREDICTED_LAUNCHES.items():
        cn = cs.PREDICTED_I2V_LAUNCHES[name]
        assert cs.predicted_launches(exact, 50, True, False)[name] == ext + 50 * (per_g + per_v)
        assert cs.predicted_launches(exact, 50, True, True)[name] == cn[0] + 50 * (cn[1] + cn[2])
        assert cs.predicted_launches(step, 50, False, False)[name] == 17 * (per_g + per_v)
        assert cs.predicted_launches(finer, 50, False, False)[name] == (
            17 * per_v + 25 * (per_g - per_v) + 25 * per_v + 50 * per_v)
