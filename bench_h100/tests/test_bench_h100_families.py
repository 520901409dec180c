"""The model-family seam (``families/``): a family added as new files only
runs through the harness unchanged, today's two configurations are pinned
at their published widths, and what the seam refuses."""

import copy
import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from bench_h100 import check, families, harness, weights
from bench_h100.tests.tiny import tiny_cell, tiny_config, tiny_traffic
from bench_h100.trace import Tracer
from bench_h100.work import bounds

SEED = 2 ** 31 + 1201

TOY = '''"""A toy family: the SD1.5 family's pieces, each hook counted."""

import collections

from bench_h100 import families
from bench_h100.families import sd15_animatediff as base

ENTERED = collections.Counter()


def _counted(name):
    def hook(*args, **kwargs):
        ENTERED[name] += 1
        return getattr(base, name)(*args, **kwargs)
    return hook


for _name in families.HOOKS:
    globals()[_name] = _counted(_name)
'''


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def copy_root(tmp_path) -> str:
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return root


def digests(root: str):
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "bench_h100")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def write_json(root: str, rel: str, obj) -> None:
    with open(os.path.join(root, rel), "w") as fh:
        json.dump(obj, fh, indent=1)


def test_a_family_added_as_new_files_only_runs_correct(tmp_path):
    root = copy_root(tmp_path)
    before = digests(root)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    old = copy.deepcopy(bench)
    sound = harness.run(tiny_cell("t2v_camera.b2", limits={}), SEED, 0.0, False, "cpu",
                        time.perf_counter())["checks"]

    # the new files: a family module, its configuration, traffic and limits
    with open(os.path.join(root, "bench_h100", "families", "toy.py"), "w") as fh:
        fh.write(TOY)
    write_json(root, "bench_h100/configs/toy-tiny.json",
               dict(tiny_config("sd15-ad3-t2v"), name="toy-tiny", family="toy"))
    write_json(root, "bench_h100/traffic/toy.b2.json", tiny_traffic("t2v_camera.b2"))
    write_json(root, "bench_h100/limits/toy.b2.json",
               {"cell": "toy.b2",
                "limits": {k: 3 * v["value"] + 1e-6 for k, v in sound.items()}})
    # ... and the new entries
    bench["configs"].append({"name": "toy-tiny", "source": "a test",
                             "file": "bench_h100/configs/toy-tiny.json", "reduced": [],
                             "why": "a family added as files"})
    bench["workloads"].append({"name": "toy.b2", "config": "toy-tiny", "traffic": "toy.b2",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "video_s.toy", "unit": "s/video", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": ["toy.b2"]})
    bench["per_layer"].append({"name": "mfu.toy", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "models",
                               "moves": "video_s.toy", "workloads": ["toy.b2"]})
    write_json(root, "BENCHMARK.json", bench)

    cell = harness.load_cell("toy.b2", root)
    toy = cell.family
    assert toy.__file__ == os.path.join(root, "bench_h100", "families", "toy.py")
    out = harness.run(cell, SEED, 0.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    # the same work as the family it reuses, number for number
    assert {k: v["value"] for k, v in out["checks"].items()} == \
        {k: v["value"] for k, v in sound.items()}
    assert set(out["metrics"]) == {"mfu.toy"}
    assert set(toy.ENTERED) == set(families.HOOKS), set(families.HOOKS) - set(toy.ENTERED)
    # nothing that was there changed: the files, and BENCHMARK.json's old entries
    after = digests(root)
    assert {k: after[k] for k in before} == before
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        now = json.load(fh)
    for key, value in old.items():
        assert now[key][:len(value)] == value if isinstance(value, list) else now[key] == value


# job FLOPs and (network, parameter, shape) digests of the two configurations
# at their published widths, as the harness counted them before the seam
PINNED = {
    "t2v_camera.b2": (8221047090728960,
                      "070c375aa6473b97db03dc695911a1c00772a92aeff6fc7237dfa608308ef7d4"),
    "i2v_rgb.b1": (5190474544459776,
                   "dc43c56c3f8812d1414d2a7880e52bea1c4ca8515345a46fa8b657e4f541bbad"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_configurations_are_pinned_at_their_published_widths(name):
    cell = harness.load_cell(name)
    assert "family" not in cell.config and cell.family.__name__.endswith(families.DEFAULT)
    flops, digest = PINNED[name]
    assert cell.family.job_flops(cell.config, cell.traffic)["job"] == flops
    h = hashlib.sha256()
    for key, module in sorted(cell.family.networks(cell.config).items()):
        assert all(p.device.type == "meta" for p in module.parameters())
        for param, shape, _, _ in weights._leaves(module):
            h.update(f"{key} {param} {tuple(shape)}\n".encode())
    assert h.hexdigest() == digest


def test_a_missing_or_incomplete_family_is_refused_before_a_run(tmp_path):
    root = copy_root(tmp_path)
    path = os.path.join(root, "bench_h100", "configs", "sd15-ad3-t2v.json")
    with open(path) as fh:
        config = json.load(fh)
    write_json(root, "bench_h100/configs/sd15-ad3-t2v.json", dict(config, family="absent"))
    with pytest.raises(SystemExit, match="no family module"):
        harness.load_cell("t2v_camera.b2", root)
    with open(os.path.join(root, "bench_h100", "families", "absent.py"), "w") as fh:
        fh.write("def networks(config, device='meta'):\n    return {}\n")
    with pytest.raises(SystemExit, match="lacks"):
        harness.load_cell("t2v_camera.b2", root)


def test_a_family_kernel_entry_joins_the_table_and_replaces_no_common_one():
    assert families.load(families.DEFAULT, harness.ROOT).kernels() == {}
    common = next(iter(bounds.KERNELS))
    with pytest.raises(ValueError, match="replace common"):
        Tracer(True, {common: ("fused", lambda *a, **k: (0.0, 0.0))})
    new = ("group_norm", "group_norm_fwd")
    tracer = Tracer(True, {new: ("norms", lambda *a, **k: (1.0, 1.0))})
    assert tracer.kernels[new][0] == "norms" and set(bounds.KERNELS) < set(tracer.kernels)


def _outputs(text: float):
    frames = torch.zeros(1, 1, 2, 2, 3, dtype=torch.uint8)
    return {"text": torch.full((2, 3), text), "latents": torch.ones(2), "condition": None,
            "rep": {"m": (torch.ones(1, 2), torch.zeros(1, 2, dtype=torch.long))},
            "init": torch.ones(2), "steps": {}, "grads": {}, "frames": frames,
            "guided_steps": 0}


def test_a_family_number_joins_the_common_ones_under_a_name_of_its_own():
    got, ref = _outputs(1.5), _outputs(1.0)
    numbers = check.readings(got, ref, lambda g, r: {"pooled": 0.25})
    assert numbers["pooled"] == 0.25 and numbers["text"] == pytest.approx(0.5)
    assert set(numbers) - {"pooled"} == set(check.readings(got, ref))
    assert not check.verdict(numbers, {k: 1.0 for k in numbers if k != "pooled"})
    with pytest.raises(ValueError, match="reuse common names"):
        check.readings(got, ref, lambda g, r: {"text": 0.0})
