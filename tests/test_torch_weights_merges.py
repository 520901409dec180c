"""The assembler's optional merges against the JAX package, on the CPU.

Numpy paths only (no JAX compile), so every comparison is bit for bit:

* ``convert_ldm_unet(extract_ema=)``: a DreamBooth-style LDM UNet dict with
  and without more than 100 ``model_ema.*`` shadows, the flag set and
  unset; the same keys and values as the JAX package's, and the same
  warning in each mismatch;
* ``assemble_pipeline_state_dicts`` with a kohya image LoRA (``lora_unet``
  and ``lora_te`` pairs, a linear and a 1x1-conv target) and two motion
  LoRAs; with an adapter LoRA, a kohya pair and two motion LoRAs all on one
  key (the merge order shows in the bits); with an EMA DreamBooth file;
* ``assemble_state_dicts`` passing the four merge arguments on.

The synthetic model directory of ``tests/test_torch_runtime.py`` holds the
same assembly with every merge at once (``test_assembled_state_dicts_with_
every_merge_equal_jax`` there)."""

import os
import warnings

import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

from motionclone_tpu.weights import ldm as jldm
from motionclone_tpu.weights import load as jload
from motionclone_tpu_torch.weights import ldm as tldm
from motionclone_tpu_torch.weights import load as tload
from motionclone_tpu_torch.weights import lora as tlora
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = "model.diffusion_model."


def _ldm_unet(seed):
    """An LDM UNet dict in the SD1.5 block layout (2 layers a block,
    downsamplers at input_blocks 3/6/9), a different random value per key."""
    rng = np.random.default_rng(seed)
    shapes = {}

    def add(key, shape=(4, 4)):
        shapes[P + key] = shape

    for i in (0, 2):
        add(f"time_embed.{i}.weight"), add(f"time_embed.{i}.bias", (4,))
    add("input_blocks.0.0.weight", (4, 4, 3, 3)), add("input_blocks.0.0.bias", (4,))
    for i in range(1, 12):
        if i in (3, 6, 9):
            add(f"input_blocks.{i}.0.op.weight", (4, 4, 3, 3))
            add(f"input_blocks.{i}.0.op.bias", (4,))
            continue
        add(f"input_blocks.{i}.0.in_layers.0.weight", (4,))
        add(f"input_blocks.{i}.0.in_layers.2.weight", (4, 4, 3, 3))
        add(f"input_blocks.{i}.0.emb_layers.1.weight")
        add(f"input_blocks.{i}.0.out_layers.3.weight", (4, 4, 3, 3))
        if i < 10:
            add(f"input_blocks.{i}.1.norm.weight", (4,))
            add(f"input_blocks.{i}.1.proj_in.weight", (4, 4, 1, 1))
            add(f"input_blocks.{i}.1.transformer_blocks.0.attn1.to_q.weight")
    add("middle_block.0.in_layers.2.weight", (4, 4, 3, 3))
    add("middle_block.1.norm.weight", (4,))
    add("middle_block.2.in_layers.2.weight", (4, 4, 3, 3))
    for i in range(12):
        add(f"output_blocks.{i}.0.in_layers.2.weight", (4, 4, 3, 3))
        add(f"output_blocks.{i}.0.skip_connection.weight", (4, 4, 1, 1))
        if i >= 3:
            add(f"output_blocks.{i}.1.norm.weight", (4,))
            add(f"output_blocks.{i}.1.transformer_blocks.0.attn2.to_k.weight")
    for up in ("2.1", "5.2", "8.2"):
        add(f"output_blocks.{up}.conv.weight", (4, 4, 3, 3))
        add(f"output_blocks.{up}.conv.bias", (4,))
    add("out.0.weight", (4,)), add("out.0.bias", (4,))
    add("out.2.weight", (4, 4, 3, 3)), add("out.2.bias", (4,))
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}


def _with_ema(sd, seed, n_keys=None):
    """``sd`` plus the ``model_ema.*`` shadows (other random values) of its
    first ``n_keys`` keys (of every key when None)."""
    rng = np.random.default_rng(seed)
    ema = {"model_ema." + "".join(k.split(".")[1:]): rng.standard_normal(v.shape, dtype=np.float32)
           for k, v in list(sd.items())[:n_keys]}
    return {**sd, **ema}


def _torch(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def _assert_equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{what} {k}")


def _messages(record):
    return [str(w.message) for w in record]


@pytest.mark.parametrize("case,extract,ema_keys,warns", [
    ("ema_taken", True, None, None),
    ("ema_present_flag_unset", False, None, "both EMA and non-EMA"),
    ("flag_set_no_ema", True, 100, "no EMA weights"),
    ("neither", False, 0, None),
])
def test_convert_ldm_unet_extract_ema_equals_jax(case, extract, ema_keys, warns):
    """The counterpart of tests/test_weights.py's ``test_ldm_unet_extract_ema``:
    the EMA set is taken only with the flag and more than 100 shadows; each
    mismatch warns with the JAX package's message."""
    base = _ldm_unet(0)
    sd = _with_ema(base, 1, ema_keys)
    # the detection threshold is a key count: more than 100 shadows
    assert (sum(k.startswith("model_ema.") for k in sd) > 100) == (ema_keys is None)
    with warnings.catch_warnings(record=True) as j_rec:
        warnings.simplefilter("always")
        want = jldm.convert_ldm_unet(sd, extract_ema=extract)
    if warns:
        with pytest.warns(UserWarning, match=warns) as t_rec:
            got = tldm.convert_ldm_unet(_torch(sd), extract_ema=extract)
        assert _messages(t_rec) == _messages(j_rec)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = tldm.convert_ldm_unet(_torch(sd), extract_ema=extract)
        assert not j_rec
    _assert_equal(got, want, case)
    plain = jldm.convert_ldm_unet(base)
    for k, v in want.items():
        # the EMA-taken weights are the shadows, never the non-EMA ones
        assert np.array_equal(v, plain[k]) != (case == "ema_taken"), k


# ---------------------------------------------------------------------------
# the assembler
# ---------------------------------------------------------------------------


def _pair(rng, out_dim, in_dim, rank=2, conv=False):
    tail = (1, 1) if conv else ()
    return (rng.standard_normal((out_dim, rank) + tail, dtype=np.float32),
            rng.standard_normal((rank, in_dim) + tail, dtype=np.float32))


def _kohya(pairs, rng):
    """{kohya name: (target shape)} -> a kohya LoRA dict with ``.alpha`` keys."""
    lora = {}
    for name, shape in pairs.items():
        up, down = _pair(rng, shape[0], shape[1], conv=len(shape) == 4)
        lora.update({name + ".lora_up.weight": up, name + ".lora_down.weight": down,
                     name + ".alpha": np.asarray(2.0, np.float32)})
    return lora


def _diffusers(targets, rng):
    """{module key without ``.weight``: (out, in)} -> a processor-format LoRA."""
    lora = {}
    for key, (o, i) in targets.items():
        parent, proj = key.rsplit(".", 1)
        proj = proj if proj != "0" else parent.rsplit(".", 1)[1]
        parent = parent if not key.endswith("to_out.0") else parent.rsplit(".", 1)[0]
        up, down = _pair(rng, o, i)
        lora[f"{parent}.processor.{proj}_lora.up.weight"] = up
        lora[f"{parent}.processor.{proj}_lora.down.weight"] = down
    return lora


UNET_KEYS = {
    "down_blocks.0.attentions.0.proj_in.weight": (8, 8, 1, 1),
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight": (8, 8),
    "up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight": (8, 8),
    "up_blocks.1.motion_modules.0.temporal_transformer.transformer_blocks.0"
    ".attention_blocks.0.to_q.weight": (8, 8),
    "up_blocks.1.motion_modules.0.temporal_transformer.transformer_blocks.0"
    ".attention_blocks.0.to_out.0.weight": (8, 8),
    "up_blocks.1.motion_modules.0.temporal_transformer.transformer_blocks.0"
    ".attention_blocks.0.to_out.0.bias": (8,),
}
MOTION = "up_blocks.1.motion_modules.0.temporal_transformer.transformer_blocks.0.attention_blocks.0"
CLIP_KEYS = {
    "text_model.encoder.layers.0.self_attn.q_proj.weight": (6, 6),
    "text_model.encoder.layers.0.mlp.fc1.weight": (12, 6),
    "text_model.final_layer_norm.weight": (6,),
}


def _model_dir(root, rng):
    for sub, shapes in (("unet", UNET_KEYS), ("vae", {"decoder.conv_in.weight": (2, 2)}),
                        ("text_encoder", CLIP_KEYS)):
        os.makedirs(os.path.join(root, sub))
        st_numpy.save_file({k: rng.standard_normal(s, dtype=np.float32)
                            for k, s in shapes.items()},
                           os.path.join(root, sub, "diffusion_pytorch_model.safetensors"))
    return root


def _save(root, name, sd):
    path = os.path.join(root, name)
    st_numpy.save_file(sd, path)
    return path


def _kohya_name(prefix, key):
    return f"{prefix}_{key[:-len('.weight')].replace('.', '_')}"


def _both(root, **kw):
    return (tload.assemble_pipeline_state_dicts(root, **kw),
            jload.assemble_pipeline_state_dicts(root, **kw))


def test_assemble_applies_image_and_motion_loras_equal_jax(tmp_path):
    """The counterpart of tests/test_weights.py's
    ``test_assemble_applies_image_and_motion_loras``: a kohya image LoRA on
    two UNet targets (a linear, a 1x1 conv) and two text-encoder linears,
    two motion LoRAs at alphas 1.0 and 0.5."""
    rng = np.random.default_rng(0)
    root = _model_dir(str(tmp_path), rng)
    image = _kohya({
        _kohya_name("lora_unet", "down_blocks.0.attentions.0.proj_in.weight"): (8, 8, 1, 1),
        _kohya_name("lora_unet", "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
                                 ".to_q.weight"): (8, 8),
        _kohya_name("lora_te", "text_model.encoder.layers.0.self_attn.q_proj.weight"): (6, 6),
        _kohya_name("lora_te", "text_model.encoder.layers.0.mlp.fc1.weight"): (12, 6),
    }, rng)
    motion = [_save(root, f"motion_{i}.safetensors",
                    _diffusers({f"{MOTION}.to_q": (8, 8), f"{MOTION}.to_out.0": (8, 8)}, rng))
              for i in range(2)]
    kw = dict(lora_model_path=_save(root, "image.safetensors", image), lora_alpha=0.7,
              motion_lora_configs=[(motion[0], 1.0), (motion[1], 0.5)])
    got, want = _both(root, **kw)
    plain = jload.assemble_pipeline_state_dicts(root)
    for sub in want:
        _assert_equal(got[sub], want[sub], sub)
    changed = {sub: sorted(k for k in want[sub]
                           if not np.array_equal(want[sub][k], plain[sub][k])) for sub in want}
    assert changed == {
        "unet": sorted(k for k in UNET_KEYS if "bias" not in k and "up_blocks.1.attentions" not in k),
        "vae": [],
        "text_encoder": sorted(k for k in CLIP_KEYS if "final_layer_norm" not in k),
    }


def test_merge_order_equals_jax(tmp_path):
    """A kohya pair, the adapter LoRA and two motion LoRAs all add to one
    key: the port merges them in the JAX package's order (kohya, adapter,
    then the motion LoRAs in list order), which shows in the bits."""
    rng = np.random.default_rng(1)
    root = _model_dir(str(tmp_path), rng)
    key = f"{MOTION}.to_q.weight"
    image = _save(root, "image.safetensors", _kohya({_kohya_name("lora_unet", key): (8, 8)}, rng))
    adapter = _save(root, "adapter.safetensors", _diffusers({f"{MOTION}.to_q": (8, 8)}, rng))
    motion = [_save(root, f"motion_{i}.safetensors", _diffusers({f"{MOTION}.to_q": (8, 8)}, rng))
              for i in range(2)]
    kw = dict(lora_model_path=image, lora_alpha=0.3, adapter_lora_path=adapter,
              adapter_lora_scale=0.7, motion_lora_configs=[(motion[0], 1.0), (motion[1], 0.5)])
    got, want = _both(root, **kw)
    _assert_equal(got["unet"], want["unet"], "unet")
    # the same merges in another order land on other bits
    from motionclone_tpu_torch.weights.io import load_state_dict

    sd = tload.assemble_pipeline_state_dicts(root)["unet"]
    for path, alpha in ((motion[1], 0.5), (motion[0], 1.0), (adapter, 0.7)):
        sd = tlora.merge_diffusers_lora(sd, load_state_dict(path), alpha=alpha)
    sd = tlora.merge_kohya_lora(sd, load_state_dict(image), alpha=0.3, prefix="lora_unet")
    np.testing.assert_allclose(sd[key].numpy(), want["unet"][key], rtol=1e-5, atol=1e-5)
    assert not np.array_equal(sd[key].numpy(), want["unet"][key])


def _dreambooth_dir(root, rng):
    """A model directory whose UNet is the diffusers image of ``_ldm_unet``
    and a DreamBooth file with the LDM UNet and its EMA shadows."""
    os.makedirs(os.path.join(root, "unet"))
    st_numpy.save_file(jldm.convert_ldm_unet(_ldm_unet(5)),
                       os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"))
    for sub, shapes in (("vae", {"decoder.conv_in.weight": (2, 2)}), ("text_encoder", CLIP_KEYS)):
        os.makedirs(os.path.join(root, sub))
        st_numpy.save_file({k: rng.standard_normal(s, dtype=np.float32)
                            for k, s in shapes.items()},
                           os.path.join(root, sub, "diffusion_pytorch_model.safetensors"))
    return _save(root, "dreambooth.safetensors", _with_ema(_ldm_unet(6), 7))


@pytest.mark.parametrize("extract", [True, False])
def test_assemble_dreambooth_extract_ema_equals_jax(tmp_path, extract):
    """``dreambooth_extract_ema`` reaches ``convert_ldm_unet``: the EMA
    shadows with the flag, the non-EMA weights and JAX's warning without."""
    rng = np.random.default_rng(2)
    root = str(tmp_path)
    db = _dreambooth_dir(root, rng)
    kw = dict(dreambooth_path=db, dreambooth_extract_ema=extract)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, want = _both(root, **kw)
    assert len(_messages(rec)) == (0 if extract else 2)
    _assert_equal(got["unet"], want["unet"], "unet")
    db_sd = _with_ema(_ldm_unet(6), 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        converted = jldm.convert_ldm_unet(db_sd, extract_ema=extract)
    ema = jldm.convert_ldm_unet(db_sd, extract_ema=True)
    for k, v in converted.items():
        np.testing.assert_array_equal(want["unet"][k], v, err_msg=k)
        assert np.array_equal(v, ema[k]) == extract, k


def test_assemble_state_dicts_passes_the_merges_on(tmp_path):
    """``assemble_state_dicts`` (what the runtime and the weights cache
    call) takes the four merge arguments and passes them on: its UNet and
    CLIP equal the JAX assembler's with the same merges."""
    rng = np.random.default_rng(3)
    root = str(tmp_path)
    db = _dreambooth_dir(root, rng)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    te_key = "text_model.encoder.layers.0.mlp.fc1.weight"
    width = jldm.convert_ldm_unet(_ldm_unet(5))[key].shape
    image = _save(root, "image.safetensors", _kohya({
        _kohya_name("lora_unet", key): width, _kohya_name("lora_te", te_key): (12, 6)}, rng))
    motion = _save(root, "motion.safetensors",
                   _diffusers({key[:-len(".weight")]: width}, rng))
    kw = dict(dreambooth_path=db, lora_model_path=image, lora_alpha=0.4,
              motion_lora_configs=[(motion, 0.5)], dreambooth_extract_ema=True)
    got = tload.assemble_state_dicts(root, **kw)
    want = jload.assemble_pipeline_state_dicts(root, **kw)
    plain = jload.assemble_pipeline_state_dicts(root, dreambooth_path=db,
                                                dreambooth_extract_ema=True)
    _assert_equal(got["unet"], want["unet"], "unet")
    assert not np.array_equal(want["unet"][key], plain["unet"][key])
    assert not np.array_equal(want["text_encoder"][te_key], plain["text_encoder"][te_key])
    for k, v in want["text_encoder"].items():
        np.testing.assert_array_equal(got["text_encoder"][k].numpy(), v, err_msg=k)
