"""The harness on the CPU: a whole run at a tiny size on the program's
plain path, the window rule, the result line, files found by name, and
the trace's reduction."""

import json
import math
import os
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import check, harness, run as run_cli
from bench_h100.tests.tiny import tiny_cell
from bench_h100.trace import Call, reduce_events


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["t2v_camera.b2", "i2v_rgb.b1"])
def test_a_tiny_run_end_to_end(cell):
    c = tiny_cell(cell)
    out = harness.run(c, 2 ** 31 + 17, 0.0, False, "cpu", time.perf_counter())
    assert out["attempted"] == c.traffic["batch"] and out["failed"] == 0
    video = "video_s.sweep" if cell == "t2v_camera.b2" else "video_s.clip"
    assert set(out["metrics"]) == {video, "peak_mem_gb", "setup_s"}
    assert out["metrics"][video]["unit"] == "s/video"
    want = {"text", "latents", "rep", "rep_index", "init", "guided", "vanilla", "guidance",
            "decode"} | ({"condition"} if "i2v" in cell else set())
    assert set(out["checks"]) == want
    assert all(math.isfinite(v["value"]) for v in out["checks"].values())
    assert set(out["diagnostics"]["setup_stages_s"]) == {"imports", "weights", "program_imports",
                                                        "program_modules", "program",
                                                        "inputs", "warm_up"}
    assert sum(out["diagnostics"]["setup_stages_s"].values()) == pytest.approx(
        out["setup_s"])
    # the same seed gives the same readings
    again = harness.run(c, 2 ** 31 + 17, 0.0, False, "cpu", time.perf_counter())
    assert {k: v["value"] for k, v in again["checks"].items()} == \
        {k: v["value"] for k, v in out["checks"].items()}


def test_a_cell_with_no_limits_file_or_a_partial_one_is_not_correct(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    os.remove(os.path.join(root, "bench_h100", "limits", "i2v_rgb.b1.json"))
    with pytest.raises(SystemExit, match="no limits file"):
        harness.load_cell("i2v_rgb.b1", root)
    full = tiny_cell("i2v_rgb.b1").limits
    partial = {k: v for k, v in full.items() if k != "guidance"}
    out = harness.run(tiny_cell("i2v_rgb.b1", limits=partial), 2 ** 31 + 23, 0.0, False, "cpu",
                      time.perf_counter())
    assert not out["correct"]
    assert out["checks"]["guidance"]["limit"] is None
    assert not check.verdict({}, {})


def test_a_loop_other_than_one_closed_client_is_refused(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    path = os.path.join(root, "bench_h100", "traffic", "t2v_camera.b2.json")
    with open(path) as fh:
        mix = json.load(fh)
    mix["loop"]["clients"] = 4
    with open(path, "w") as fh:
        json.dump(mix, fh)
    with pytest.raises(SystemExit, match="closed with one client"):
        harness.load_cell("t2v_camera.b2", root)


def test_a_traced_tiny_run_reports_the_per_layer_metrics_it_can_read():
    c = tiny_cell("t2v_camera.b2")
    out = harness.run(c, 3, 0.0, True, "cpu", time.perf_counter())
    # the CPU runs no kernel: the readers of device time find nothing
    assert set(out["metrics"]) == {"guided_step_ms.sweep", "vanilla_step_ms.sweep", "mfu.sweep"}
    assert out["busy_s"] == 0 and out["traced_window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("durations, seconds, max_jobs, jobs", [
    ([30.0, 30.0, 30.0], 40.0, 4, 1),   # a second job would end past the window
    ([10.0, 10.0, 10.0, 10.0], 35.0, 4, 3),  # 20 + 10 fits, 30 + 10 does not
    ([10.0, 10.0, 10.0, 10.0, 10.0], 40.0, 5, 4),  # 30 + 10 fits exactly
    ([10.0, 25.0, 10.0], 40.0, 4, 2),   # the longest so far decides
    ([5.0] * 10, 40.0, 4, 4),           # no more jobs than the traffic has
    ([50.0], 1.0, 4, 1),                # the first job always runs
])
def test_the_window_holds_whole_jobs(durations, seconds, max_jobs, jobs):
    now = [0.0]

    def job(k):
        now[0] += durations[k]
        return k

    results, window, each = harness.closed_loop(job, seconds, max_jobs, lambda: None,
                                                clock=lambda: now[0])
    assert results == list(range(jobs))
    assert window == sum(durations[:jobs]) and each == durations[:jobs]


def test_the_last_line_has_the_result_keys_and_the_checks_last():
    out = {"correct": True, "attempted": 2, "failed": 0, "peak_bytes": 5,
           "metrics": {"mfu": {"value": 1.0, "unit": "%"}}, "busy_s": 1.0,
           "traced_window_s": 2.0, "breakdown": {"device_ops": [], "idle_gaps": []},
           "checks": {"text": {"value": 0.1, "limit": 0.2}}}
    dev = {"platform": "gpu", "kind": "card", "count": 1}
    line = run_cli.result_line(out, dev, True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["device"] == dict(dev, memory_peak_bytes=5, busy_s=1.0, window_s=2.0)
    untraced = run_cli.result_line(out, dev, False)
    assert list(untraced) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    json.dumps(line)


def test_forbidden_modules_are_matched_by_whole_top_level_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "motionclone_tpu_torch_fake", object())
    assert run_cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert run_cli.forbidden_modules() == ["flax"]


def test_a_new_traffic_mix_and_metric_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), os.path.join(root, "bench_h100"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    traffic = os.path.join(root, "bench_h100", "traffic")
    with open(os.path.join(traffic, "t2v_camera.b2.json")) as fh:
        mix = dict(json.load(fh), name="t2v_camera.b1", batch=1)
    with open(os.path.join(traffic, "t2v_camera.b1.json"), "w") as fh:
        json.dump(mix, fh)
    limits = os.path.join(root, "bench_h100", "limits")
    shutil.copy(os.path.join(limits, "t2v_camera.b2.json"),
                os.path.join(limits, "t2v_camera.b1.json"))
    with open(os.path.join(root, "bench_h100", "metrics", "jobs_done.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.jobs)\n")
    bench["workloads"].append({"name": "t2v_camera.b1", "config": "sd15-ad3-t2v",
                               "traffic": "t2v_camera.b1", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "pipeline",
                               "moves": "video_s.clip", "workloads": ["t2v_camera.b1"]})
    bench["per_layer"].append({"name": "mfu.clip2", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "models",
                               "moves": "video_s.clip", "workloads": ["t2v_camera.b1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    cell = harness.load_cell("t2v_camera.b1", root)
    assert cell.traffic["batch"] == 1 and cell.config["name"] == "sd15-ad3-t2v"
    assert [m["name"] for m in cell.per_layer] == ["jobs_done", "mfu.clip2"]
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_gb", "setup_s"}
    reader = harness.load_reader("jobs_done", root)
    assert reader(SimpleNamespace(jobs=3)) == 3.0
    # a new family of an existing quantity is read by the quantity's reader
    assert harness.load_reader("mfu.clip2", root).__module__ == "bench_h100.metrics.mfu.clip2"
    assert harness.load_cell("t2v_camera.b2", root).per_layer[0]["name"] == "guided_step_ms.sweep"


class Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, end, cuda=False):
        self._v = (name, start, end, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU


def test_the_trace_reduction_attributes_kernels_and_names_gaps():
    calls = [Call("flash_fwd", "attention", 1.0, 1.0), Call("fused_resnet_kernel", "fused",
                                                           1.0, 1.0)]
    ms = 1_000_000
    events = [
        Ev("bench_h100/window", 0, 100 * ms),
        Ev("bench_h100/guided_step", 0, 60 * ms),
        Ev("bench_h100/decode", 60 * ms, 100 * ms),
        Ev("bench_h100.op/0", 5 * ms, 6 * ms),
        Ev("bench_h100.op/1", 20 * ms, 30 * ms),
        Ev("aten::mm", 40 * ms, 41 * ms),
        Ev("kernel_a", 10 * ms, 20 * ms, cuda=True),
        Ev("kernel_b", 25 * ms, 35 * ms, cuda=True),
        Ev("kernel_b", 45 * ms, 50 * ms, cuda=True),
        Ev("kernel_c", 95 * ms, 105 * ms, cuda=True),  # cut at the window's end
        # the profiler's copies of the ranges on the device's timeline: the
        # calls' kernels lie inside them; they are not work themselves
        Ev("bench_h100.op/0", 10 * ms, 20 * ms, cuda=True),
        Ev("bench_h100.op/1", 25 * ms, 35 * ms, cuda=True),
        Ev("bench_h100/guided_step", 10 * ms, 50 * ms, cuda=True),
    ]
    s = reduce_events(events, calls)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.030)  # 10-20 (10), 25-35 (10), 45-50 (5), 95-100 (5)
    assert calls[0].device_s == pytest.approx(0.010) and calls[1].device_s == pytest.approx(0.010)
    assert s.device_ops == [("kernel_b", pytest.approx(0.015)), ("kernel_a", pytest.approx(0.01)),
                            ("kernel_c", pytest.approx(0.005))]
    # gaps 0-10, 20-25, 35-45, 50-95: the longest first, by the span open at its middle
    assert s.idle_gaps == [("decode", pytest.approx(0.045)), ("guided_step", pytest.approx(0.01)),
                           ("guided_step", pytest.approx(0.01)),
                           ("guided_step", pytest.approx(0.005))]
