"""The port's t2v runtime against the JAX package, on the CPU in f32.

One synthetic model directory (tests/test_cli_synthetic_e2e.py's
``_build_model_dir``: diffusers-layout base weights with config.json files
and a tokenizer, a DreamBooth LDM checkpoint, a motion-module ``.ckpt``
with ``pos_encoder.pe`` buffers, an adapter LoRA, at a small SD1.5-shaped
topology) serves every case:

* ``assemble_pipeline_state_dicts`` equals the JAX package's key for key
  and array for array (exact);
* the runtime's loaded UNet, VAE and CLIP equal ``weights/from_jax.py`` of
  the JAX package's loaded parameters (exact);
* ``encode_prompt`` equals the JAX CLIP on the same ids (atol 1e-4), and
  ``encode_video`` the JAX VAE encode with JAX's posterior noise put in
  through the ``utils.rng.draw_normal`` seam (atol 1e-4);
* motion-representation files (``.npz`` with meta, and the reference
  ``.pt``) written by either package load in the other (exact);
* the whole slice: ``t2v_main(... --device cpu --float32)`` writes the mp4
  with the reference's name, the representation ``.npz`` and
  ``inference_config.json``; its extraction and final latents equal
  ``MotionClonePipeline`` driven by hand from the same modules, embeddings
  and ``draw_normal`` noise (exact); a second run reuses the cached
  representation;
* the layout flags outside torchrun exit before any file is read:
  ``--frame-shard-mode gspmd`` naming its ROADMAP.md list,
  ``--frame-shard`` and ``--cfg-pair`` naming torchrun;
* the weights cache: a warm runtime's modules equal a cold one's bit for
  bit, and a touched source, another dtype or LoRA scale, or an entry
  without the controlnet misses;
* ``--approx``, ``--weights-cache`` and ``--resume`` through ``t2v_main``
  and ``i2v_main`` (an approx run's skip steps, a second call's hit, an
  interrupted and resumed run equal to an uninterrupted one), and
  ``--approx``'s refusals with the JAX package's messages;
* i2v, on the same directory plus tests/test_cli_synthetic_e2e.py's
  SparseCtrl checkpoints (both flavours) and a condition PNG: the
  controlnet checkpoint loads strictly and equals the JAX package's load
  carried across (exact), a missing key raises; a runtime built from an
  i2v YAML holds the controlnet and its guided step differs from the
  unconditioned one; the RGB flavour's condition latents equal the JAX VAE
  encode with JAX's ``CN_IMAGE_POSTERIOR`` noise through the
  ``draw_normal`` seam (atol 1e-4); ``i2v_main(... --device cpu
  --float32)`` writes the mp4 with the reference's name, its extraction and
  final latents equal the pipeline driven by hand with the same conditions
  (exact); ``i2v_main``'s refusals.

No test runs the JAX CLI or the JAX sampling: tests/test_torch_pipeline.py
holds the sampling against JAX."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.config import load_model_config as j_load_model_config
from motionclone_tpu.diffusion import guidance as jguid
from motionclone_tpu.io.tokenizer import ClipTokenizer as JTokenizer
from motionclone_tpu.models.clip_text import CLIPTextModel as JCLIP
from motionclone_tpu.models.vae import AutoencoderKL as JVAE, sample_latents as j_sample_latents
from motionclone_tpu.utils import rng as jrng
from motionclone_tpu.weights import load as jload
from motionclone_tpu_torch.cli import UNPORTED, build_parser, i2v_main, t2v_main
from motionclone_tpu_torch.config import Example, load_examples, load_inference_config
from motionclone_tpu_torch.diffusion import guidance as tguid
from motionclone_tpu_torch.io.video import preprocess_video, read_video_frames, write_video
from motionclone_tpu_torch.models.sparse_controlnet import scatter_condition
from motionclone_tpu_torch.pipeline import runner
from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline
from motionclone_tpu_torch.utils import rng as trng
from motionclone_tpu_torch.weights import load as tload
from motionclone_tpu_torch.weights.from_jax import clip_state_dict_from_flax, state_dict_from_flax
from test_cli_synthetic_e2e import _build_controlnet, _build_model_dir
from test_torch_models import one_torch_thread  # noqa: F401

SD = os.path.join("models", "SD")
PROMPT = "a cat running"
ARGS = ["--pretrained-model-path", SD, "--inference_config", "inference.yaml",
        "--examples", "examples.jsonl", "--motion-representation-save-dir", "reps",
        "--generated-videos-save-dir", "out", "--W", "64", "--H", "64", "--L", "4",
        "--float32", "--device", "cpu"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    _build_model_dir(root)
    frames = np.random.default_rng(0).integers(0, 255, size=(6, 64, 64, 3), dtype=np.uint8)
    write_video(os.path.join(root, "ref.mp4"), frames, fps=8)
    with open(os.path.join(root, "examples.jsonl"), "w") as f:
        f.write(json.dumps({"video_path": "ref.mp4", "new_prompt": PROMPT, "seed": 42}) + "\n")
    return root


@pytest.fixture(scope="module")
def infer_cfg(model_dir):
    return load_inference_config(os.path.join(model_dir, "inference.yaml"), width=64,
                                 height=64, video_length=4)


@pytest.fixture(scope="module")
def runtime(model_dir, infer_cfg):
    return runner.MotionCloneRuntime(os.path.join(model_dir, SD), infer_cfg, device="cpu",
                                     dtype=torch.float32, config_root=model_dir)


def _assets(root, cfg):
    j = lambda p: os.path.join(root, p)
    return dict(motion_module_path=j(cfg.motion_module), dreambooth_path=j(cfg.dreambooth_path),
                adapter_lora_path=j(cfg.adapter_lora_path),
                adapter_lora_scale=cfg.adapter_lora_scale)


@pytest.fixture(scope="module")
def jax_side(model_dir, infer_cfg):
    """The JAX package's assembled state dicts, configs and parameters."""
    sd_dir = os.path.join(model_dir, SD)
    sds = jload.assemble_pipeline_state_dicts(sd_dir, **_assets(model_dir, infer_cfg))
    unet_cfg = jload.apply_unet_diffusers_config(
        j_load_model_config(os.path.join(model_dir, infer_cfg.model_config))[0], sd_dir)
    vae_cfg, clip_cfg = jload.vae_config_from_dir(sd_dir), jload.clip_config_from_dir(sd_dir)
    return dict(
        sds=sds, vae_cfg=vae_cfg, clip_cfg=clip_cfg,
        unet=jload.unet_params_from_state_dict(sds["unet"], unet_cfg),
        vae=jload.vae_params_from_state_dict(sds["vae"], vae_cfg),
        clip=jload.clip_params_from_state_dict(sds["text_encoder"], clip_cfg),
    )


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_assembled_state_dicts_equal_jax(model_dir, infer_cfg, jax_side):
    got = tload.assemble_pipeline_state_dicts(os.path.join(model_dir, SD),
                                              **_assets(model_dir, infer_cfg))
    want = jax_side["sds"]
    assert sorted(got) == sorted(want) == ["text_encoder", "unet", "vae"]
    for sub in want:
        assert sorted(got[sub]) == sorted(want[sub]), sub
        for k, v in want[sub].items():
            assert got[sub][k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[sub][k].numpy(), v, err_msg=f"{sub} {k}")
    # the merge chain reached the UNet: motion modules, the .ckpt's
    # pos_encoder buffer (dropped at the load), the DreamBooth layers
    assert any("motion_modules." in k for k in got["unet"])
    assert any(k.endswith("pos_encoder.pe") for k in got["unet"])


def test_assembled_state_dicts_with_every_merge_equal_jax(model_dir, infer_cfg, tmp_path):
    """The directory's assets plus every optional merge: the DreamBooth file
    with EMA shadows of its UNet (taken), a kohya image LoRA on two UNet
    linears, a UNet 1x1 conv and two text-encoder linears, and two motion
    LoRAs at alphas 1.0 and 0.5: equal to the JAX package's assembly,
    bit for bit."""
    from safetensors import numpy as st_numpy

    sd_dir, assets = os.path.join(model_dir, SD), _assets(model_dir, infer_cfg)
    plain = jload.assemble_pipeline_state_dicts(sd_dir, **assets)
    rng = np.random.default_rng(11)
    db = st_numpy.load_file(assets["dreambooth_path"])
    db.update({"model_ema." + "".join(k.split(".")[1:]): rng.standard_normal(v.shape, np.float32)
               for k, v in list(db.items()) if k.startswith("model.diffusion_model.")})
    ema_db = str(tmp_path / "dreambooth_ema.safetensors")
    st_numpy.save_file(db, ema_db)

    def pair(out_dim, in_dim, tail=()):
        return (rng.standard_normal((out_dim, 2) + tail, np.float32),
                rng.standard_normal((2, in_dim) + tail, np.float32))

    unet, clip = plain["unet"], plain["text_encoder"]
    image_targets = (
        [("lora_unet", k) for k in sorted(unet) if "motion_modules." not in k
         and k.endswith(("attn1.to_q.weight", "attn2.to_v.weight"))][:2]
        + [("lora_unet", k) for k in sorted(unet) if k.endswith("proj_in.weight")
           and unet[k].ndim == 4][:1]
        + [("lora_te", k) for k in sorted(clip) if k.endswith(("q_proj.weight", "fc1.weight"))][:2])
    assert len(image_targets) == 5
    image = {}
    for prefix, k in image_targets:
        name = f"{prefix}_{k[:-len('.weight')].replace('.', '_')}"
        w = (unet if prefix == "lora_unet" else clip)[k]
        up, down = pair(w.shape[0], w.shape[1], w.shape[2:])
        image.update({name + ".lora_up.weight": up, name + ".lora_down.weight": down,
                      name + ".alpha": np.asarray(2.0, np.float32)})
    image_path = str(tmp_path / "image_lora.safetensors")
    st_numpy.save_file(image, image_path)
    motion_targets = [k[:-len(".weight")] for k in sorted(unet) if "motion_modules." in k
                      and k.endswith(("attention_blocks.0.to_q.weight",
                                      "attention_blocks.1.to_v.weight"))][:2]
    assert len(motion_targets) == 2
    motion = []
    for i in range(2):
        lora = {}
        for t in motion_targets:
            parent, proj = t.rsplit(".", 1)
            up, down = pair(*unet[t + ".weight"].shape)
            lora[f"{parent}.processor.{proj}_lora.up.weight"] = up
            lora[f"{parent}.processor.{proj}_lora.down.weight"] = down
        motion.append(str(tmp_path / f"motion_lora_{i}.safetensors"))
        st_numpy.save_file(lora, motion[-1])

    kw = dict(assets, dreambooth_path=ema_db, lora_model_path=image_path, lora_alpha=0.8,
              motion_lora_configs=[(motion[0], 1.0), (motion[1], 0.5)],
              dreambooth_extract_ema=True)
    got = tload.assemble_pipeline_state_dicts(sd_dir, **kw)
    want = jload.assemble_pipeline_state_dicts(sd_dir, **kw)
    for sub in want:
        assert sorted(got[sub]) == sorted(want[sub]), sub
        for k, v in want[sub].items():
            assert got[sub][k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[sub][k].numpy(), v, err_msg=f"{sub} {k}")
    merged = [t for _, t in image_targets] + [t + ".weight" for t in motion_targets]
    for k in merged:
        sub = "text_encoder" if k.startswith("text_model.") else "unet"
        assert not np.array_equal(want[sub][k], plain[sub][k]), k
    # every DreamBooth-replaced UNet weight is its EMA shadow
    image_layers = [k for k in want["unet"] if "motion_modules." not in k and k not in merged]
    assert image_layers and all(not np.array_equal(want["unet"][k], plain["unet"][k])
                                for k in image_layers)


def test_kohya_lora_merge_equals_jax(jax_side):
    """``merge_kohya_lora`` on the assembled UNet and text encoder equals the
    JAX package's merge, bit for bit: a linear and a 1x1-conv target, the
    ``.alpha`` keys skipped, the other prefix's pairs left alone."""
    from motionclone_tpu.weights.lora import merge_kohya_lora as j_merge
    from motionclone_tpu_torch.weights.lora import merge_kohya_lora as t_merge

    rng = np.random.default_rng(3)
    lora = {}
    for prefix, sub in (("lora_unet", "unet"), ("lora_te", "text_encoder")):
        targets = [k for k, v in jax_side["sds"][sub].items()
                   if k.endswith(".weight") and v.ndim in (2, 4) and v.shape[1] > 1][:2]
        assert targets, sub
        for k in targets:
            w = jax_side["sds"][sub][k]
            name = f"{prefix}_{k[:-len('.weight')].replace('.', '_')}"
            tail = (1, 1) if w.ndim == 4 else ()
            lora[name + ".lora_down.weight"] = rng.standard_normal((2, w.shape[1]) + tail,
                                                                   dtype=np.float32)
            lora[name + ".lora_up.weight"] = rng.standard_normal((w.shape[0], 2) + tail,
                                                                 dtype=np.float32)
            lora[name + ".alpha"] = np.float32(2.0)
    t_lora = {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()}
    for prefix, sub in (("lora_unet", "unet"), ("lora_te", "text_encoder")):
        base = jax_side["sds"][sub]
        want = j_merge(base, lora, alpha=0.8, prefix=prefix)
        got = t_merge({k: torch.from_numpy(v) for k, v in base.items()}, t_lora,
                      alpha=0.8, prefix=prefix)
        assert sorted(got) == sorted(want)
        changed = [k for k in want if not np.array_equal(want[k], base[k])]
        assert len(changed) == 2, (sub, changed)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{sub} {k}")
    with pytest.raises(KeyError, match="not found"):
        t_merge({}, t_lora, prefix="lora_unet")


def test_loaded_modules_equal_jax_params(runtime, jax_side):
    pipe = runtime.pipeline
    for module, want in ((pipe.unet, state_dict_from_flax(jax_side["unet"])),
                         (pipe.vae, state_dict_from_flax(jax_side["vae"])),
                         (pipe.text_encoder, clip_state_dict_from_flax(jax_side["clip"]))):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_load_into_is_strict():
    from motionclone_tpu_torch.models.clip_text import CLIPTextModel, tiny_clip_config

    sd = CLIPTextModel(tiny_clip_config()).state_dict()
    make = lambda: CLIPTextModel(tiny_clip_config())
    extra = dict(sd, **{"text_model.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unexpected"):
        tload.load_into(make, extra, torch.float32)
    short = {k: v for k, v in sd.items() if "final_layer_norm" not in k}
    with pytest.raises(ValueError, match="not covered"):
        tload.load_into(make, short, torch.float32)
    wrong = dict(sd, **{"text_model.final_layer_norm.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tload.load_into(make, wrong, torch.float32)
    loaded = tload.load_into(make, {k: v.bfloat16() for k, v in sd.items()}, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu"
               for p in loaded.parameters())


def test_load_into_runs_no_initialiser():
    """The meta-device build runs no ``torch.nn.init`` initialiser (in a
    fresh interpreter, CLIP's embedding ``normal_`` would import torch's
    Python meta kernels and sympy with them), and restores them after."""
    import subprocess
    import sys

    script = (
        "import sys, torch\n"
        "from motionclone_tpu_torch.models.clip_text import CLIPTextModel, tiny_clip_config\n"
        "from motionclone_tpu_torch.weights.load import load_into\n"
        "sd = CLIPTextModel(tiny_clip_config()).state_dict()\n"
        "before = 'sympy' in sys.modules\n"
        "m = load_into(lambda: CLIPTextModel(tiny_clip_config()), sd, torch.float32)\n"
        "assert all(torch.equal(m.state_dict()[k], v) for k, v in sd.items())\n"
        "print(before or 'sympy' not in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"]
    w = torch.zeros(64)
    torch.nn.init.normal_(w)
    assert w.abs().sum() > 0


def test_missing_asset_raises_with_its_path(model_dir, infer_cfg):
    cfg = dataclasses.replace(infer_cfg, motion_module="weights/absent_mm.ckpt")
    with pytest.raises(FileNotFoundError, match="absent_mm.ckpt"):
        runner.MotionCloneRuntime(os.path.join(model_dir, SD), cfg, device="cpu",
                                  dtype=torch.float32, config_root=model_dir)


# ---------------------------------------------------------------------------
# text and the VAE
# ---------------------------------------------------------------------------


def test_encode_prompt_equals_jax_clip(model_dir, runtime, jax_side, infer_cfg):
    prompts = [PROMPT + infer_cfg.positive_prompt, "a road in the mountain"]
    uncond, cond = runtime.encode_prompt(prompts, infer_cfg.negative_prompt,
                                         num_videos_per_prompt=2)
    assert cond.shape == (4, 77, 16) and uncond.shape == (4, 77, 16)
    tok = JTokenizer.from_pretrained(os.path.join(model_dir, SD))
    clip = JCLIP(cfg=jax_side["clip_cfg"])
    ids = lambda texts: jnp.asarray(np.concatenate([tok.encode_padded(t) for t in texts]))
    want_cond = np.repeat(np.asarray(clip.apply(jax_side["clip"], ids(prompts))), 2, axis=0)
    want_uncond = np.repeat(np.asarray(clip.apply(
        jax_side["clip"], ids([infer_cfg.negative_prompt] * 2))), 2, axis=0)
    np.testing.assert_allclose(cond.numpy(), want_cond, atol=1e-4, rtol=0)
    np.testing.assert_allclose(uncond.numpy(), want_uncond, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="batch size"):
        runtime.encode_prompt(prompts, ["only one"])


def _jax_draw(shape, seed, domain, device):
    """JAX's noise for (seed, domain), through the port's draw seam."""
    noise = jax.random.normal(jrng.seed_key(seed, domain), tuple(shape), dtype=jnp.float32)
    return torch.from_numpy(np.array(noise)).to(device)


def test_encode_video_equals_jax_vae_on_jax_noise(model_dir, runtime, jax_side, monkeypatch):
    video = preprocess_video(os.path.join(model_dir, "ref.mp4"), 64, 64, 4)
    monkeypatch.setattr(trng, "draw_normal", _jax_draw)
    got = runtime.encode_video(video, seed=42)
    vae = JVAE(cfg=jax_side["vae_cfg"])
    mean, logvar = vae.apply(jax_side["vae"], jnp.asarray(video)[None], method=vae.encode)
    want = j_sample_latents(mean, logvar, jrng.seed_key(42, jrng.VAE_POSTERIOR))
    want = np.asarray(want) * jax_side["vae_cfg"].scaling_factor
    assert got.shape == (1, 4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_decode_is_uint8_on_the_device(runtime):
    lat = torch.randn(1, 2, 8, 8, 4, generator=torch.Generator().manual_seed(5))
    frames = runtime.decode_latents(lat)
    pixels = runtime.pipeline.decode_latents(lat).numpy()
    assert frames.dtype == np.uint8 and frames.shape == (2, 64, 64, 3)
    want = np.round(np.clip(pixels.astype(np.float32) / 2 + 0.5, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(frames, want)


# ---------------------------------------------------------------------------
# motion representation files
# ---------------------------------------------------------------------------


def _rep(seed=6):
    r = np.random.default_rng(seed)
    name = ("up_blocks.1.motion_modules.{}.temporal_transformer.transformer_blocks.0."
            "attention_blocks.{}")
    return {name.format(m, a): (r.random((1, 16, 2, 4, 1)).astype(np.float32),
                                r.integers(0, 4, size=(1, 16, 2, 4, 1)).astype(np.uint8))
            for m in range(3) for a in range(2)}


@pytest.mark.parametrize("ext", [".npz", ".pt"])
def test_motion_rep_files_load_in_both_packages(tmp_path, ext):
    rep = _rep()
    meta = {"height": 64, "seed_motion": 42, "guidance_blocks": ["up_blocks.1"]}
    wrote = {"jax": str(tmp_path / f"jax{ext}"), "port": str(tmp_path / f"port{ext}")}
    jguid.save_motion_representation(wrote["jax"], rep, meta=meta)
    tguid.save_motion_representation(wrote["port"], {k: (torch.from_numpy(v), torch.from_numpy(i))
                                                     for k, (v, i) in rep.items()}, meta=meta)
    for who, path in wrote.items():
        got_t, got_j = tguid.load_motion_representation(path), jguid.load_motion_representation(path)
        assert sorted(got_t) == sorted(got_j) == sorted(rep), who
        for k, (v, i) in rep.items():
            assert got_t[k][0].dtype == torch.float32 and got_t[k][1].dtype == torch.uint8
            np.testing.assert_array_equal(got_t[k][0].numpy(), v)
            np.testing.assert_array_equal(got_t[k][1].numpy(), i)
            np.testing.assert_array_equal(np.asarray(got_j[k][0]), v)
            np.testing.assert_array_equal(np.asarray(got_j[k][1]), i)
        want_meta = meta if ext == ".npz" else None
        assert tguid.load_motion_representation_meta(path) == want_meta
        assert jguid.load_motion_representation_meta(path) == want_meta


def test_rep_cache_lookup_and_validation(tmp_path, infer_cfg):
    meta = runner.motion_rep_meta(infer_cfg, 42)
    d = str(tmp_path)
    assert runner.locate_cached_rep(d, "v", meta) == (os.path.join(d, "v.npz"), None)
    tguid.save_motion_representation(os.path.join(d, "v.npz"), _rep(), meta=meta)
    assert runner.locate_cached_rep(d, "v", meta)[1] == os.path.join(d, "v.npz")
    assert runner.locate_cached_rep(d, "v", dict(meta, seed_motion=7))[1] is None
    tguid.save_motion_representation(os.path.join(d, "w.pt"), _rep())
    assert runner.locate_cached_rep(d, "w", meta) == (os.path.join(d, "w.pt"),) * 2
    rep = tguid.load_motion_representation(os.path.join(d, "v.npz"))
    runner._validate_motion_representation(rep, "v.npz", infer_cfg)
    with pytest.raises(ValueError, match="frames"):
        runner._validate_motion_representation(
            rep, "v.npz", dataclasses.replace(infer_cfg, video_length=8))
    with pytest.raises(ValueError, match="motion_guidance_blocks"):
        runner._validate_motion_representation(
            rep, "v.npz", dataclasses.replace(infer_cfg, motion_guidance_blocks=("up_blocks.2",)))


# ---------------------------------------------------------------------------
# the whole slice through the CLI
# ---------------------------------------------------------------------------


def test_t2v_main_runs_the_slice_to_an_mp4(model_dir, monkeypatch, capsys):
    monkeypatch.chdir(model_dir)
    seen = {}
    sample, extract = MotionClonePipeline.sample_latents, \
        MotionClonePipeline.extract_motion_representation

    def spy_sample(self, *args, **kwargs):
        seen["latents"] = sample(self, *args, **kwargs)
        return seen["latents"]

    def spy_extract(self, *args, **kwargs):
        seen["rep"] = extract(self, *args, **kwargs)
        return seen["rep"]

    monkeypatch.setattr(MotionClonePipeline, "sample_latents", spy_sample)
    monkeypatch.setattr(MotionClonePipeline, "extract_motion_representation", spy_extract)
    rt, paths = t2v_main(ARGS)
    cfg = rt.infer_cfg
    new_prompt = PROMPT + cfg.positive_prompt
    name = "ref_" + new_prompt.strip().replace(" ", "_") + "42_42.mp4"
    assert name == "ref_a_cat_running8k,_high_detail42_42.mp4"
    assert paths == [os.path.join("out", name)]
    frames, _ = read_video_frames(paths[0])
    assert frames.shape == (4, 64, 64, 3) and frames.dtype == np.uint8
    assert os.path.exists(os.path.join("out", "inference_config.json"))
    assert tguid.load_motion_representation_meta(os.path.join("reps", "ref.npz")) == \
        runner.motion_rep_meta(cfg, 42)
    assert sorted(rt.timings) == ["decode_write", "extract", "guided_ms", "guided_skip_ms",
                                  "passes_ms", "sample", "text", "vanilla_ms",
                                  "vanilla_skip_ms", "weights_cache"]
    assert (len(rt.timings["guided_ms"]), len(rt.timings["vanilla_ms"])) == (2, 2)
    assert {k: len(v) for k, v in rt.timings["passes_ms"].items()} == {
        "guided/unet_plain": 2, "guided/unet_guided_fwd": 2, "guided/unet_guided_bwd": 2,
        "vanilla/unet_plain": 2}
    assert rt.timings["guided_skip_ms"] == rt.timings["vanilla_skip_ms"] == []
    assert rt.timings["weights_cache"] == "off"

    # by hand: the same modules, embeddings and draw_normal noise
    pipe = MotionClonePipeline(rt.unet_cfg, rt.sched_cfg, cfg, rt.pipeline.unet,
                               vae=rt.pipeline.vae, device="cpu", dtype=torch.float32)
    video = torch.from_numpy(preprocess_video("ref.mp4", 64, 64, 4))
    empty, _ = rt.encode_prompt("", "")
    latents = pipe.encode_video(video, seed=42)
    noise = trng.draw_normal(latents.shape, 42, trng.EXTRACT_NOISE, "cpu")
    rep = pipe.fns.extract(latents, noise, empty)
    assert sorted(rep) == sorted(seen["rep"])
    for k, (v, i) in rep.items():
        assert torch.equal(v, seen["rep"][k][0]) and torch.equal(i, seen["rep"][k][1])
    uncond, cond = rt.encode_prompt(new_prompt, cfg.negative_prompt)
    init = trng.draw_normal((1, 4, 8, 8, 4), 42, trng.INIT_LATENTS, "cpu")
    want = pipe.fns.sample(init, uncond, cond, rep)
    assert torch.equal(seen["latents"], want)
    capsys.readouterr()

    # a second run takes the cached representation, with the aliases of
    # the JAX CLI's flags accepted and reported
    seen.clear()
    t2v_main(ARGS + ["--attention-impl", "xla", "--visible_gpu", "0", "--compile-cache", "cc"])
    out = capsys.readouterr().out
    assert "motion representation reused from reps/ref.npz" in out
    assert "unfused path" in out and "--visible_gpu" in out and "--compile-cache" in out
    assert "rep" not in seen and torch.equal(seen["latents"], want)


# the JAX package's layout flags, each with its default and the refusal
# that applies to it outside torchrun: the GSPMD flavour is not ported (its
# ROADMAP.md list), --frame-shard needs a torchrun world of its size, and
# t2v/i2v take --cfg-pair only with --frame-shard
_UNPORTED_ARGV = {"frame_shard": (["--frame-shard", "2"], 0, "torchrun --nproc-per-node 2"),
                  "frame_shard_mode": (["--frame-shard-mode", "gspmd"], "shardmap",
                                       "ROADMAP.md"),
                  "cfg_pair": (["--cfg-pair"], False, "torchrun --nproc-per-node 2N")}


@pytest.mark.parametrize("flag", sorted(_UNPORTED_ARGV))
def test_unported_flags_exit_with_their_roadmap_item(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # exits before it reads a file
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv, default, message = _UNPORTED_ARGV[flag]
    defaults = build_parser("a.yaml", "b.jsonl").parse_args([])
    assert getattr(defaults, flag) == default
    if flag in UNPORTED:
        assert UNPORTED[flag][0] == default
    with pytest.raises(SystemExit, match=message):
        t2v_main(ARGS + argv)
    assert not os.listdir(tmp_path)


def test_example_from_json():
    e = Example.from_json({"video_path": "v.mp4", "new_prompt": "p"})
    assert (e.seed, e.condition_image_paths, e.image_index) == (None, (), (0,))


# ---------------------------------------------------------------------------
# i2v: SparseCtrl on the same model directory
# ---------------------------------------------------------------------------

FLAVOURS = ("latent", "pixel")  # configs/i2v_rgb.yaml, configs/i2v_sketch.yaml


@pytest.fixture(scope="module")
def i2v_dir(model_dir):
    """``model_dir`` plus a SparseCtrl checkpoint and YAML per flavour
    (with the ``pos_encoder.pe`` buffer real checkpoints carry), an i2v
    inference YAML per flavour, a 48x64 RGB condition PNG and its
    examples.jsonl (the condition at frame 1)."""
    import yaml
    from PIL import Image

    from motionclone_tpu.config import load_yaml as j_load_yaml

    for flavour in FLAVOURS:
        path = _build_controlnet(model_dir, flavour)
        infer = j_load_yaml(os.path.join(model_dir, "inference.yaml"))
        infer.update(controlnet_path=os.path.relpath(path, model_dir),
                     controlnet_config=f"sparsectrl_{flavour}.yaml", controlnet_scale=0.9)
        with open(os.path.join(model_dir, f"inference_{flavour}.yaml"), "w") as f:
            yaml.safe_dump(infer, f)
    img = np.random.default_rng(1).integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(model_dir, "cond.png"))
    with open(os.path.join(model_dir, "examples_i2v.jsonl"), "w") as f:
        f.write(json.dumps({"video_path": "ref.mp4", "new_prompt": PROMPT, "seed": 42,
                            "condition_image_paths": ["cond.png"], "image_index": [1]})
                + "\n")
    return model_dir


def _i2v_cfg(root, flavour):
    return load_inference_config(os.path.join(root, f"inference_{flavour}.yaml"), width=64,
                                 height=64, video_length=4)


@pytest.fixture(scope="module")
def i2v_runtimes(i2v_dir):
    return {flavour: runner.MotionCloneRuntime(
        os.path.join(i2v_dir, SD), _i2v_cfg(i2v_dir, flavour), device="cpu",
        dtype=torch.float32, config_root=i2v_dir) for flavour in FLAVOURS}


def _i2v_argv(flavour):
    argv = list(ARGS)
    argv[argv.index("inference.yaml")] = f"inference_{flavour}.yaml"
    argv[argv.index("examples.jsonl")] = "examples_i2v.jsonl"
    return argv


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_controlnet_checkpoint_loads_strictly_and_equals_jax(i2v_dir, i2v_runtimes, flavour):
    """The runtime's controlnet equals the JAX package's load of the same
    ``.ckpt`` carried across by ``state_dict_from_flax``, exactly; the
    loader drops the ``pos_encoder.pe`` buffers and refuses a short one."""
    from motionclone_tpu.config import load_yaml as j_load_yaml
    from motionclone_tpu.models.sparse_controlnet import SparseControlNetConfig as JCnConfig
    from motionclone_tpu.weights.io import load_state_dict as j_load_state_dict
    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from motionclone_tpu_torch.weights.io import load_state_dict

    rt = i2v_runtimes[flavour]
    path = os.path.join(i2v_dir, rt.infer_cfg.controlnet_path)
    kwargs = j_load_yaml(os.path.join(i2v_dir, rt.infer_cfg.controlnet_config))[
        "controlnet_additional_kwargs"]
    sd_dir = os.path.join(i2v_dir, SD)
    j_unet_cfg = jload.apply_unet_diffusers_config(
        j_load_model_config(os.path.join(i2v_dir, rt.infer_cfg.model_config))[0], sd_dir)
    want = state_dict_from_flax(jload.controlnet_params_from_state_dict(
        j_load_state_dict(path), JCnConfig.from_yaml_dict(kwargs, j_unet_cfg)))
    got = rt.pipeline.controlnet.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    raw = load_state_dict(path)
    assert any(k.endswith("pos_encoder.pe") for k in raw)
    short = {k: v for k, v in tload.controlnet_state_dict(raw).items()
             if not k.startswith("controlnet_mid_block")}
    with pytest.raises(ValueError, match="not covered"):
        tload.load_into(lambda: SparseControlNetModel(rt.cn_cfg), short, torch.float32,
                        "controlnet")


def test_i2v_runtime_conditions_the_guided_step(i2v_dir, i2v_runtimes):
    """An i2v YAML never gives an unconditioned video: the runtime holds the
    controlnet, and the first guided step with the example's condition
    differs from the same step without it."""
    rt = i2v_runtimes["pixel"]
    assert rt.cn_cfg is not None and rt.pipeline.controlnet is not None
    assert not rt.cn_cfg.use_simplified_condition_embedding
    example = load_examples(os.path.join(i2v_dir, "examples_i2v.jsonl"))[0]
    cn_cond = rt.sampling_condition(example, 42, 0.9, config_root=i2v_dir)
    cond, mask, scale = cn_cond
    assert cond.shape == (1, 4, 64, 64, 3) and scale == 0.9
    assert mask[0, :, 0, 0, 0].tolist() == [0.0, 1.0, 0.0, 0.0]
    fns = rt.pipeline.fns
    r = np.random.default_rng(8)
    lat = torch.from_numpy(r.standard_normal((1, 4, 8, 8, 4)).astype(np.float32))
    uncond, emb = rt.encode_prompt(PROMPT)
    rep = fns.extract(lat, lat, uncond)
    t, tp = (int(x) for x in fns.timesteps[:2])
    plain, _ = fns.guided_step(lat, t, tp, 1.0, uncond, emb, rep)
    conditioned, _ = fns.guided_step(lat, t, tp, 1.0, uncond, emb, rep, cn_cond)
    assert (plain - conditioned).abs().max() > 1e-4
    # the runtime without the controlnet entries is the t2v runtime
    assert runner.MotionCloneRuntime(
        os.path.join(i2v_dir, SD), load_inference_config(
            os.path.join(i2v_dir, "inference.yaml"), width=64, height=64, video_length=4),
        device="cpu", dtype=torch.float32, config_root=i2v_dir).pipeline.controlnet is None


def test_rgb_condition_equals_jax_vae_on_jax_noise(i2v_dir, i2v_runtimes, jax_side,
                                                    monkeypatch):
    """The RGB flavour's sampling condition: the condition image (Pillow's
    resize, bit for bit) VAE-encoded with the seed's CN_IMAGE_POSTERIOR
    draw and scaled, scattered to frame 1; JAX's noise through the seam."""
    from motionclone_tpu.io.video import load_condition_images as j_load_images

    rt = i2v_runtimes["latent"]
    example = load_examples(os.path.join(i2v_dir, "examples_i2v.jsonl"))[0]
    monkeypatch.setattr(trng, "draw_normal", _jax_draw)
    cond, mask, _ = rt.sampling_condition(example, 42, 0.9, config_root=i2v_dir)
    imgs = j_load_images([os.path.join(i2v_dir, "cond.png")], 64, 64)
    vae = JVAE(cfg=jax_side["vae_cfg"])
    mean, logvar = vae.apply(jax_side["vae"], jnp.asarray(imgs * 2.0 - 1.0)[None],
                             method=vae.encode)
    want = j_sample_latents(mean, logvar, jrng.seed_key(42, jrng.CN_IMAGE_POSTERIOR))
    want = np.asarray(want) * jax_side["vae_cfg"].scaling_factor
    assert cond.shape == (1, 4, 8, 8, 4)
    np.testing.assert_allclose(cond[:, 1:2].numpy(), want, atol=1e-4, rtol=0)
    assert not cond[:, [0, 2, 3]].any() and mask[:, 1].all() and not mask[:, 0].any()


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_i2v_main_runs_the_slice_to_an_mp4(i2v_dir, flavour, monkeypatch):
    monkeypatch.chdir(i2v_dir)
    seen = {}
    sample, extract = MotionClonePipeline.sample_latents, \
        MotionClonePipeline.extract_motion_representation

    def spy_sample(self, *args, **kwargs):
        seen["latents"] = sample(self, *args, **kwargs)
        return seen["latents"]

    def spy_extract(self, *args, **kwargs):
        seen["rep"] = extract(self, *args, **kwargs)
        return seen["rep"]

    monkeypatch.setattr(MotionClonePipeline, "sample_latents", spy_sample)
    monkeypatch.setattr(MotionClonePipeline, "extract_motion_representation", spy_extract)
    argv = _i2v_argv(flavour) + ["--motion-representation-save-dir", f"reps_{flavour}",
                                 "--generated-videos-save-dir", f"out_{flavour}"]
    rt, paths = i2v_main(argv)
    cfg = rt.infer_cfg
    name = "ref_" + (PROMPT + cfg.positive_prompt).strip().replace(" ", "_") + "42_42.mp4"
    assert paths == [os.path.join(f"out_{flavour}", name)]
    frames, _ = read_video_frames(paths[0])
    assert frames.shape == (4, 64, 64, 3) and frames.dtype == np.uint8
    assert "condition" in rt.timings

    # by hand: the same modules, the reference's frame 1 for extraction, the
    # condition image for sampling
    pipe = rt.pipeline
    video = preprocess_video("ref.mp4", 64, 64, 4)
    empty, _ = rt.encode_prompt("", "")
    latents = pipe.encode_video(torch.from_numpy(video), seed=42)
    frames1 = (latents[:, [1]] if flavour == "latent"
               else torch.from_numpy((video[None, [1]] + 1.0) / 2.0))
    cond, mask = scatter_condition(frames1, (1,), 4)
    noise = trng.draw_normal(latents.shape, 42, trng.EXTRACT_NOISE, "cpu")
    rep = pipe.fns.extract(latents, noise, empty, (cond, mask, 0.9))
    assert sorted(rep) == sorted(seen["rep"])
    for k, (v, i) in rep.items():
        assert torch.equal(v, seen["rep"][k][0]) and torch.equal(i, seen["rep"][k][1])
    example = load_examples("examples_i2v.jsonl")[0]
    cn_cond = rt.sampling_condition(example, 42, 0.9)
    uncond, cond_emb = rt.encode_prompt(PROMPT + cfg.positive_prompt, cfg.negative_prompt)
    init = trng.draw_normal((1, 4, 8, 8, 4), 42, trng.INIT_LATENTS, "cpu")
    want = pipe.fns.sample(init, uncond, cond_emb, rep, cn_cond=cn_cond)
    assert torch.equal(seen["latents"], want)
    assert not torch.equal(want, pipe.fns.sample(init, uncond, cond_emb, rep))


@pytest.mark.parametrize("flag", sorted(_UNPORTED_ARGV))
def test_i2v_unported_flags_exit_with_their_roadmap_item(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # exits before it reads a file
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv, _, message = _UNPORTED_ARGV[flag]
    with pytest.raises(SystemExit, match=message):
        i2v_main(_i2v_argv("latent") + argv)
    assert not os.listdir(tmp_path)


def test_i2v_main_refusals(i2v_dir, i2v_runtimes, monkeypatch, tmp_path):
    """Without the controlnet entries, without condition images, with a
    count that differs from image_index, and with an unported flag, before
    any weight is read."""
    monkeypatch.chdir(i2v_dir)
    with pytest.raises(ValueError, match="controlnet_path and controlnet_config"):
        i2v_main(ARGS)  # the t2v YAML
    bad = {"none": {"video_path": "ref.mp4", "new_prompt": "p"},
           "count": {"video_path": "ref.mp4", "new_prompt": "p",
                     "condition_image_paths": ["cond.png"], "image_index": [0, 2]}}
    for what, example in bad.items():
        path = str(tmp_path / f"{what}.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps(example) + "\n")
        argv = _i2v_argv("pixel")
        argv[argv.index("examples_i2v.jsonl")] = path
        with pytest.raises(ValueError, match="condition_image_paths" if what == "none"
                           else "image_index"):
            i2v_main(argv)
    defaults = build_parser("a", "b", default_seed=76739).parse_args([])
    assert defaults.default_seed == 76739
    example = Example(video_path="ref.mp4", new_prompt="p")
    with pytest.raises(ValueError, match="no condition_image_paths"):
        i2v_runtimes["pixel"].run_example(example, motion_rep_dir=str(tmp_path / "r"),
                                          output_dir=str(tmp_path / "o"))


# ---------------------------------------------------------------------------
# the weights cache, --approx, --weights-cache and --resume
# ---------------------------------------------------------------------------


def _state(rt):
    pipe = rt.pipeline
    mods = dict(unet=pipe.unet, vae=pipe.vae, text_encoder=pipe.text_encoder)
    if pipe.controlnet is not None:
        mods["controlnet"] = pipe.controlnet
    return {name: m.state_dict() for name, m in mods.items()}


def _assert_same_modules(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for k, v in a[name].items():
            assert v.dtype == b[name][k].dtype and torch.equal(v, b[name][k]), f"{name} {k}"


def test_weights_cache_hit_loads_the_cold_modules_bit_for_bit(model_dir, infer_cfg, runtime,
                                                             tmp_path):
    sd_dir, wc = os.path.join(model_dir, SD), str(tmp_path / "wc")
    make = lambda cfg=infer_cfg, dtype=torch.float32: runner.MotionCloneRuntime(
        sd_dir, cfg, device="cpu", dtype=dtype, config_root=model_dir, weights_cache=wc)
    cold = make()
    assert cold.weights_cache_state == "miss" and runtime.weights_cache_state == "off"
    assert [f for f in os.listdir(wc) if f.startswith("params-torch-")] == os.listdir(wc)
    warm = make()
    assert warm.weights_cache_state == "hit"
    _assert_same_modules(_state(warm), _state(cold))
    _assert_same_modules(_state(warm), _state(runtime))
    # another dtype or LoRA scale is another entry; a touched source misses
    assert make(dtype=torch.bfloat16).weights_cache_state == "miss"
    assert make(dataclasses.replace(infer_cfg, adapter_lora_scale=0.5)
                ).weights_cache_state == "miss"
    mm = os.path.join(model_dir, infer_cfg.motion_module)
    st = os.stat(mm)
    os.utime(mm, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        assert make().weights_cache_state == "miss"
        assert make().weights_cache_state == "hit"
    finally:
        os.utime(mm, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert len(os.listdir(wc)) == 4  # f32, bf16, LoRA scale 0.5, the touched source


def test_weights_cache_entry_without_the_controlnet_misses(i2v_dir, i2v_runtimes, tmp_path):
    from motionclone_tpu_torch.weights import cache as wcache

    wc = str(tmp_path / "wc")
    make = lambda: runner.MotionCloneRuntime(
        os.path.join(i2v_dir, SD), _i2v_cfg(i2v_dir, "latent"), device="cpu",
        dtype=torch.float32, config_root=i2v_dir, weights_cache=wc)
    assert make().weights_cache_state == "miss"
    (entry,) = os.listdir(wc)
    key = entry[len("params-torch-"):-len(".safetensors")]
    sds = wcache.load_params(wc, key)
    assert "controlnet" in sds
    wcache.save_params(wc, key, {c: sd for c, sd in sds.items() if c != "controlnet"})
    rt = make()
    assert rt.weights_cache_state == "miss"
    _assert_same_modules(_state(rt), _state(i2v_runtimes["latent"]))
    assert make().weights_cache_state == "hit"


MAINS = {"t2v": lambda argv: t2v_main(argv), "i2v": lambda argv: i2v_main(argv)}


def _main_argv(which, tag):
    argv = _i2v_argv("latent") if which == "i2v" else list(ARGS)
    return argv + ["--motion-representation-save-dir", f"reps_{which}",
                   "--generated-videos-save-dir", f"out_{which}_{tag}"]


_SAMPLE_LATENTS = MotionClonePipeline.sample_latents


def _spy_latents(monkeypatch, seen, on_chunk=None):
    def spy(self, *args, **kwargs):
        if on_chunk is not None:
            kwargs["on_chunk"] = on_chunk
        seen.append(_SAMPLE_LATENTS(self, *args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(MotionClonePipeline, "sample_latents", spy)


def _frames(paths):
    assert len(paths) == 1
    frames, _ = read_video_frames(paths[0])
    assert frames.shape == (4, 64, 64, 3) and frames.dtype == np.uint8
    return frames


@pytest.mark.parametrize("which", sorted(MAINS))
def test_main_runs_the_approx_caches(i2v_dir, which, monkeypatch):
    """``--approx step-extrap:2`` on the synthetic schedule (4 steps, 2
    guided): one full and one skip step per phase, timed apart, and other
    latents than the exact run's."""
    monkeypatch.chdir(i2v_dir)
    seen = []
    _spy_latents(monkeypatch, seen)
    MAINS[which](_main_argv(which, "exact"))
    rt, paths = MAINS[which](_main_argv(which, "approx") + ["--approx", "step-extrap:2"])
    _frames(paths)
    assert rt.pipeline.fns.schedule().full.tolist() == [True, False, True, False]
    assert [len(rt.timings[k]) for k in ("guided_ms", "guided_skip_ms", "vanilla_ms",
                                         "vanilla_skip_ms")] == [1, 1, 1, 1]
    assert not torch.equal(seen[1], seen[0])


@pytest.mark.parametrize("which", sorted(MAINS))
def test_main_weights_cache_second_call_hits(i2v_dir, which, monkeypatch, capsys):
    monkeypatch.chdir(i2v_dir)
    seen = []
    _spy_latents(monkeypatch, seen)
    argv = _main_argv(which, "wc") + ["--weights-cache", f"wc_{which}"]
    states = []
    for _ in range(2):
        rt, paths = MAINS[which](argv)
        _frames(paths)
        states.append(rt.timings["weights_cache"])
    assert states == ["miss", "hit"]
    assert f"weights cache wc_{which}: hit" in capsys.readouterr().out
    torch.testing.assert_close(seen[1], seen[0], rtol=0, atol=0)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("which", sorted(MAINS))
def test_main_resume_continues_an_interrupted_run(i2v_dir, which, monkeypatch):
    """An interrupted ``--resume`` run (stopped after the guided chunk)
    leaves its checkpoint in the output directory; the rerun takes it and
    ends on the uninterrupted run's latents, bit for bit, and removes it."""
    monkeypatch.chdir(i2v_dir)
    seen = []

    def stop(done, total):
        if done == 2:
            raise _Stop

    argv = _main_argv(which, "resume") + ["--resume"]
    _spy_latents(monkeypatch, seen, on_chunk=stop)
    with pytest.raises(_Stop):
        MAINS[which](argv)
    out = f"out_{which}_resume"
    (ckpt,) = [f for f in os.listdir(out) if f.startswith(".resume_")]
    assert ckpt.endswith(".mp4.npz")
    _spy_latents(monkeypatch, seen)
    rt, paths = MAINS[which](argv)
    _frames(paths)
    assert (len(rt.timings["guided_ms"]), len(rt.timings["vanilla_ms"])) == (0, 2)
    assert not any(f.startswith(".resume_") for f in os.listdir(out))
    MAINS[which](_main_argv(which, "whole"))
    torch.testing.assert_close(seen[0], seen[1], rtol=0, atol=0)


@pytest.mark.parametrize("which", sorted(MAINS))
@pytest.mark.parametrize("spec,message", [
    ("bogus", "unknown --approx mode 'bogus'"),
    ("step-cache:1", "--approx step-cache:K needs K >= 2")])
def test_main_refuses_a_bad_approx_spec(which, spec, message, tmp_path, monkeypatch):
    """JAX's messages, before any file is read or written."""
    from motionclone_tpu.cli import parse_approx as j_parse_approx

    with pytest.raises(SystemExit) as want:
        j_parse_approx(spec)
    assert str(want.value).startswith(message)
    monkeypatch.chdir(tmp_path)
    argv = _i2v_argv("latent") if which == "i2v" else list(ARGS)
    with pytest.raises(SystemExit) as got:
        MAINS[which](argv + ["--approx", spec])
    assert str(got.value) == str(want.value)
    assert not os.listdir(tmp_path)
