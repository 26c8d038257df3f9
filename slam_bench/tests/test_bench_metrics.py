"""Every per-layer reader on a recorded fixture, the trace reduction on a
fixture of device operations and ranges, and BENCHMARK.json against the
readers' declarations."""
import json

import numpy as np
import pytest

from slam_bench import peaks, trace
from slam_bench.metrics import load
from slam_bench.session import RunRecord

from .conftest import ROOT

CONFIG = json.loads((ROOT / "slam_bench/configs/tum_fr1_vga30.json").read_text())


def fixture_trace():
    """Two calls (0-100 us and 140-200 us); a step dispatched at 10-20 us
    whose graph runs two kernels (30-50, 55-60) and a copy (60-70); a
    mapping tick at 40-56; a FAST kernel (150-160) launched at 145."""
    us = 1000
    dev_s = np.array([30, 55, 60, 150]) * us
    dev_e = np.array([50, 60, 70, 160]) * us
    corr = [1, 1, 2, 3]
    names = ["step_kernel", "step_kernel_b", "Memcpy DtoH (Device -> Pinned)",
             "void fast_levels_kernel(FastTable, float, float, int, int)"]
    launch = {1: 12 * us, 2: 15 * us, 3: 145 * us}
    ranges = {"bench.call": [(0, 100 * us), (140 * us, 200 * us)],
              "bench.fused_dispatch": [(10 * us, 20 * us)],
              "bench.mapping_tick": [(40 * us, 56 * us)]}
    return trace.summarize(dev_s, dev_e, corr, names, launch, ranges)


def test_trace_reduction():
    t = fixture_trace()
    assert t["window_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx(45e-6)
    step = t["ranges"]["bench.fused_dispatch"]
    assert step == {"count": 1, "device_s": pytest.approx(35e-6), "kernels": 2}
    assert t["fast_launches"] == 1 and t["fast_s"] == pytest.approx(10e-6)
    idle = dict(t["idle_gaps"])
    # gap 0-30 inside the dispatch (the innermost range around its middle),
    # 50-55 inside the mapping tick, 160-200 inside a call, 70-150 with its
    # middle between the calls
    assert idle["bench.fused_dispatch"] == pytest.approx(30e-6)
    assert idle["bench.call"] == pytest.approx(40e-6)
    assert idle["bench.mapping_tick"] == pytest.approx(5e-6)
    assert idle["harness"] == pytest.approx(80e-6)
    assert dict(t["device_ops"])["step_kernel"] == pytest.approx(20e-6)


def test_readers_on_a_fixture():
    run = RunRecord(
        spans={"mapping": (1.5, 40), "mapping_hard_drain": (0.5, 3), "kfdb_detect_reloc": (0.02, 5),
               "reloc_candidate": (0.2, 9), "reloc_refine": (0.08, 4), "track": (9.0, 500)},
        counts={"frames": 500, "working": 470, "lost": 20, "keyframes": 25, "resets": 0},
        trace=fixture_trace(), config=CONFIG)
    shapes = peaks.level_shapes(480, 640, 8, 1.2)
    want = {
        "step_device_ms": 0.035,
        "step_kernels": 2.0,
        "fast_roofline_pct": 100.0 * peaks.fast_bound(shapes)["bound_s"] / 10e-6,
        "mapping_ms_per_kf": 2000.0 / 25,
        "keyframes_per_100_frames": 5.0,
        "reloc_ms_per_lost_frame": 300.0 / 20,
    }
    for name, value in want.items():
        assert load(name).read(run) == pytest.approx(value), name


def test_readers_return_nothing_without_data():
    empty = RunRecord(spans={}, counts={"frames": 10}, trace={}, config=CONFIG)
    for name in ("step_device_ms", "step_kernels", "fast_roofline_pct", "mapping_ms_per_kf",
                 "keyframes_per_100_frames", "reloc_ms_per_lost_frame"):
        assert load(name).read(empty) is None, name


def test_fast_bound_of_the_tum_levels():
    b = peaks.fast_bound(peaks.level_shapes(480, 640, 8, 1.2))
    assert b["pixels"] == 950532 and b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(950532 * 8 / 3.35e12)


def test_benchmark_json_matches_the_readers_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        r = load(m["name"])
        assert (r.NAME, r.UNIT, r.LAYER, r.SOURCE, r.MOVES) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (ROOT / "slam_bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "slam_bench/limits" / f"{w['name']}.json").is_file()
