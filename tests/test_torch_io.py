"""The port's file readers against the JAX package and the libraries it
replaces, on the CPU.

* YAML: ``io/yaml_subset.py`` gives exactly ``yaml.safe_load``'s result
  (values and types) on every YAML under configs/ and on ``yaml.safe_dump``
  output, and raises naming file and line outside its subset;
* configs: ``load_inference_config``, ``load_model_config`` and
  ``load_examples`` equal the JAX package's dataclasses field for field on
  every shipped config;
* tokenizer: ids equal the JAX package's ``ClipTokenizer`` (itself held
  bit-identical to Hugging Face's in tests/test_tokenizer.py) on the
  shipped prompts and edge cases, with tests/test_tokenizer.py's mini-BPE
  vocab; the token scanner's matches equal the ``regex`` pattern's;
* safetensors: the port's reader equals ``safetensors.numpy.load_file``
  (f32, f16, i64, i32, u8, bool) and ``safetensors.torch.load_file`` (bf16)
  bit for bit;
* video: frame sampling and the align-corners resize equal the JAX
  package's numpy path, and an mp4 written by the port decodes as the JAX
  package decodes it;
* i2v condition images: ``load_condition_images`` (cv2 decode, Pillow's
  bilinear resample in numpy) equals the JAX package's (Pillow) bit for bit
  on RGB, RGBA, grey, grey + alpha and palette PNGs (with and without a
  transparent entry), downscaled, upscaled and non-square; the numpy
  resample equals Pillow's on random sizes.

All comparisons are exact unless a tolerance is stated."""

import dataclasses
import glob
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from motionclone_tpu import config as jcfg
from motionclone_tpu.io import tokenizer as jtok
from motionclone_tpu.io import video as jvideo
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.io import tokenizer as ttok
from motionclone_tpu_torch.io import video as tvideo
from motionclone_tpu_torch.io import yaml_subset
from motionclone_tpu_torch.weights.io import load_state_dict
from test_tokenizer import EDGE_CASES, shipped_prompts, train_mini_bpe
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
WORKLOADS = ["t2v_camera", "t2v_object", "i2v_rgb", "i2v_sketch"]


def _same(a, b) -> bool:
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_subset_equals_safe_load_on_shipped_configs(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load(path), want)


def test_yaml_subset_equals_safe_load_on_dumped_documents():
    doc = {"unet_additional_kwargs": {
        "motion_module_resolutions": [1, 2, 4, 8], "use_inflated_groupnorm": True,
        "motion_module_kwargs": {"attention_block_types": ["Temporal_Self"],
                                 "temporal_position_encoding_max_len": 24},
    }, "beta_start": 0.00085, "weight": 2000, "scale": 50.0, "small": 1e-5,
        "prompts": ["a: b", "#tag", "it's", "", "yes", "-1", "1e-5", "null", "8k, high detail"],
        "empty": [], "none": None, "quoted": 'say "hi" \\ now\t', "café": "naïve"}
    for style in (False, None):  # block sequences; flow lists
        text = yaml.safe_dump(doc, default_flow_style=style, allow_unicode=True)
        assert _same(yaml_subset.loads(text), yaml.safe_load(text)), text
    scalars = ["0b101", "017", "0x1F", "1_000", "190:20:30", "1.5", "1.0e+5", "1e5", ".5",
               "-.inf", ".NaN", "+12", "-0", "Yes", "off", "NULL", "~", "08", "0.", "'it''s'",
               '"\\u00e9\\x41"']
    for s in scalars:
        assert _same(yaml_subset.loads(f"k: {s}"), yaml.safe_load(f"k: {s}")), s


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: {c: 2}\n", 2),                 # flow mapping
    ("a: &x 1\n", 1),                         # anchor
    ("a: 1\nb: *x\n", 2),                     # alias
    ("a: !!str 1\n", 1),                      # tag
    ("a: |\n  two\n  lines\n", 1),            # block scalar
    ("a: folded\n  plain\n", 2),              # plain scalar over two lines
    ("a: 'quoted\n  on two lines'\n", 1),     # quoted scalar over two lines
    ("a: [1,\n  2]\n", 1),                    # flow list over two lines
    ("---\na: 1\n", 1),                       # document marker
    ("a:\n\tb: 1\n", 2),                      # tab indentation
    ("a: 1\na: 2\n", 2),                      # duplicate key
    ("a:\n  - b: 1\n", 2),                    # mapping in a block sequence
])
def test_yaml_subset_raises_outside_its_subset(tmp_path, text, line):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"bad.yaml:{line}:"):
        yaml_subset.load(str(path))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WORKLOADS)
def test_inference_config_equals_jax(name):
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    overrides = dict(width=256, height=320, video_length=8)
    got = tcfg.load_inference_config(path, **overrides)
    want = jcfg.load_inference_config(path, **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _same(dataclasses.asdict(got), dataclasses.asdict(want))


def test_inference_config_spellings_and_precedence(tmp_path):
    """Both positive-prompt spellings (the corrected one wins) and the
    YAML's size keys over the fallbacks, as the JAX package."""
    path = tmp_path / "w.yaml"
    path.write_text("model_config: m.yaml\npostive_prompt: ' old'\n"
                    "positive_prompt: ' new'\nW: 320\n")
    got = tcfg.load_inference_config(str(path), width=64, height=128)
    want = jcfg.load_inference_config(str(path), width=64, height=128)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.positive_prompt, got.width, got.height) == (" new", 320, 128)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "model_config",
                                                                "*.yaml"))),
                         ids=os.path.basename)
def test_model_config_equals_jax(path):
    # the port's UNet3DConfig has SDXL's fields beside the JAX package's: equal
    # on the JAX package's, SD1.5's defaults on the others
    sd15 = dataclasses.asdict(tcfg.UNet3DConfig())
    for got, want in zip(tcfg.load_model_config(path), jcfg.load_model_config(path)):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        extra = set(got) - set(want)
        assert extra <= set(sd15)
        assert _same({k: got[k] for k in want}, want)
        assert all(_same(got[k], sd15[k]) for k in extra)


@pytest.mark.parametrize("name", WORKLOADS)
def test_examples_equal_jax(name):
    path = os.path.join(ROOT, "configs", f"{name}.jsonl")
    got = [dataclasses.asdict(e) for e in tcfg.load_examples(path)]
    assert got and got == [dataclasses.asdict(e) for e in jcfg.load_examples(path)]


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

EXTRA_TEXT = [
    "It'S A CAT'S HAT", "x'LL y'Ve z'D", "don't!'s", "ſ'ſ",  # contractions, any case
    "½ cup, ² squared, Ⅻ o'clock, ١٢٣",  # No, Nl and Arabic-Indic numbers
    "東京 タワー 한국어 的猫",  # CJK and other scripts
    "naïve café résumé Ǆemo", "tab\there\nnew line", "🚀🔥 emoji!!", "3.14159e10",
    "<|ENDOFTEXT|> <|startoftext|>x",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_tok")
    vocab, merges = train_mini_bpe(shipped_prompts() + EDGE_CASES + EXTRA_TEXT)
    with open(d / "vocab.json", "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(d / "merges.txt", "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return (jtok.ClipTokenizer(str(d / "vocab.json"), str(d / "merges.txt")),
            ttok.ClipTokenizer.from_pretrained(str(d), subfolder=""))


@pytest.mark.parametrize("group", ["shipped", "edge", "extra"])
def test_tokenizer_ids_equal_jax(tokenizers, group):
    jax_tok, port_tok = tokenizers
    texts = {"shipped": shipped_prompts(), "edge": EDGE_CASES, "extra": EXTRA_TEXT}[group]
    for text in texts:
        np.testing.assert_array_equal(port_tok.encode_padded(text),
                                      jax_tok.encode_padded(text), err_msg=repr(text))
        assert port_tok.tokenize(text) == jax_tok.tokenize(text), repr(text)
        assert port_tok.decode(port_tok.encode(text)) == jax_tok.decode(jax_tok.encode(text))


def test_token_scanner_equals_the_clip_pattern():
    """The scanner's matches equal the ``regex`` pattern's on normalised
    text, where ``re``'s ``\\w`` would take numbers of category No and Nl
    as letters."""
    for text in shipped_prompts() + EDGE_CASES + EXTRA_TEXT:
        norm = jtok._normalize(text)
        assert ttok._normalize(text) == norm
        assert ttok.split_tokens(norm) == jtok._PAT.findall(norm), repr(text)
    assert ttok.split_tokens("x²½ⅻ") == ["x", "²", "½", "ⅻ"]


# ---------------------------------------------------------------------------
# safetensors and torch pickles
# ---------------------------------------------------------------------------


def test_safetensors_reader_equals_the_library(tmp_path):
    from safetensors import numpy as st_numpy
    from safetensors import torch as st_torch

    r = np.random.default_rng(0)
    arrays = {
        "f32": r.standard_normal((3, 5)).astype(np.float32),
        "f16": r.standard_normal((4, 1, 2)).astype(np.float16),
        "i64": r.integers(-2**40, 2**40, size=(7,)),
        "i32": r.integers(-100, 100, size=(2, 2)).astype(np.int32),
        "u8": r.integers(0, 255, size=(6,)).astype(np.uint8),
        "bool": r.random(5) > 0.5,
        "scalar": np.asarray(1.5, dtype=np.float32),
        "empty": np.zeros((0, 3), dtype=np.float32),
    }
    path = str(tmp_path / "a.safetensors")
    st_numpy.save_file(arrays, path, metadata={"format": "np"})
    got, want = load_state_dict(path), st_numpy.load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    bf = {"bf16": torch.randn(9, 4, generator=torch.Generator().manual_seed(1)).bfloat16()}
    path = str(tmp_path / "b.safetensors")
    st_torch.save_file(bf, path)
    got = load_state_dict(path)["bf16"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), st_torch.load_file(path)["bf16"].view(torch.int16))


def test_safetensors_reader_refuses_a_bad_file(tmp_path):
    from safetensors import numpy as st_numpy

    path = tmp_path / "t.safetensors"
    st_numpy.save_file({"x": np.zeros((4, 4), np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="does not hold"):
        load_state_dict(str(path))
    with pytest.raises(FileNotFoundError, match="missing.safetensors"):
        load_state_dict(str(tmp_path / "missing.safetensors"))


def test_torch_pickle_is_unwrapped_and_keeps_bf16(tmp_path):
    sd = {"a.weight": torch.randn(3, 2).bfloat16(), "b.bias": torch.arange(4.0)}
    path = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": sd, "global_step": 7}, path)
    got = load_state_dict(path)
    assert sorted(got) == sorted(sd)
    assert got["a.weight"].dtype == torch.bfloat16 and torch.equal(got["a.weight"], sd["a.weight"])


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


def test_sampling_and_resize_equal_jax():
    for total, length in ((72, 16), (6, 4), (16, 16), (5, 8)):
        np.testing.assert_array_equal(tvideo.sample_indices(total, length),
                                      jvideo.sample_indices(total, length))
    x = np.random.default_rng(2).uniform(0, 255, size=(2, 17, 23, 3)).astype(np.float32)
    for hw in ((32, 48), (17, 23), (1, 5), (8, 8)):
        np.testing.assert_array_equal(tvideo.resize_bilinear_align_corners(x, *hw),
                                      jvideo.resize_bilinear_align_corners(x, *hw))


def test_video_written_by_the_port_decodes_as_jax_decodes_it(tmp_path):
    frames = np.random.default_rng(3).integers(0, 255, size=(6, 32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.mp4")
    tvideo.write_video(path, frames, fps=8)
    got, fps = tvideo.read_video_frames(path)
    want, want_fps = jvideo.read_video_frames(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 32, 48, 3) and fps == want_fps == 8
    # preprocessing: the JAX package's numpy path on the same decoded frames
    out = tvideo.preprocess_video(path, 16, 24, 4)
    picked = want[jvideo.sample_indices(6, 4)]
    ref = jvideo.resize_bilinear_align_corners(picked, 16, 24) / np.float32(127.5) - 1
    assert out.dtype == np.float32 and out.shape == (4, 16, 24, 3)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="uint8"):
        tvideo.write_video(path, frames.astype(np.float32))


def test_codec_without_cv2_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tvideo.read_video_frames(str(tmp_path / "x.mp4"))
    with pytest.raises(ImportError, match="cv2"):
        tvideo.write_video(str(tmp_path / "x.mp4"), np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ImportError, match="cv2"):
        tvideo.read_image_rgb(str(tmp_path / "x.png"))


# ---------------------------------------------------------------------------
# i2v condition images
# ---------------------------------------------------------------------------

IMAGE_MODES = ("RGB", "RGBA", "L", "LA", "P", "P-transparent")


def _save_png(path, mode, seed=4):
    from PIL import Image

    base = np.random.default_rng(seed).integers(0, 256, size=(75, 100, 4), dtype=np.uint8)
    if mode in ("RGB", "RGBA", "L", "LA"):
        img = Image.fromarray(base[..., :len(mode)] if len(mode) > 1 else base[..., 0],
                              mode)
    else:
        img = Image.fromarray(base[..., :3]).quantize(48)
        if mode == "P-transparent":
            img.info["transparency"] = 5
    img.save(path)
    return path


@pytest.mark.parametrize("mode", IMAGE_MODES)
def test_condition_images_equal_jax_bit_for_bit(mode, tmp_path):
    paths = [_save_png(str(tmp_path / "a.png"), mode),
             _save_png(str(tmp_path / "b.png"), mode, seed=5)]
    # downscaled (antialiased), upscaled, non-square both ways, unchanged
    for hw in ((64, 64), (160, 240), (48, 80), (120, 40), (75, 100)):
        want = jvideo.load_condition_images(paths, *hw)
        got = tvideo.load_condition_images(paths, *hw)
        assert got.dtype == np.float32 and got.shape == (2,) + hw + (3,)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {hw}")


def test_pillow_bilinear_resample_is_bit_exact():
    from PIL import Image

    r = np.random.default_rng(6)
    for _ in range(30):
        h, w, oh, ow = (int(v) for v in r.integers(1, 260, size=4))
        img = r.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(tvideo.resize_bilinear_pil(img, oh, ow), want,
                                      err_msg=f"{(h, w)} -> {(oh, ow)}")


def test_condition_image_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="absent.png"):
        tvideo.load_condition_images([str(tmp_path / "absent.png")], 8, 8)
    (tmp_path / "junk.png").write_bytes(b"not an image")
    with pytest.raises(IOError, match="junk.png"):
        tvideo.read_image_rgb(str(tmp_path / "junk.png"))
    with pytest.raises(ValueError, match="no condition images"):
        tvideo.load_condition_images([], 8, 8)
