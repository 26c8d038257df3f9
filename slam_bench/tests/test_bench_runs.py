"""Whole runs on the CPU at the tiny test size: each traffic mix end to
end, the result line's keys, the refusals, and the planted faults that have
to turn `correct` false."""
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from slam_bench import check, run

from .conftest import ROOT, tiny_run

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def last_line(result):
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.emit(dict(result))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_line(line, trace):
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert set(keys) - set(CONTRACT) <= {"breakdown", "counts", "checks"}
    assert line["counts"]["frames"] == line["attempted"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    group = bench["per_layer"] if trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in group}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_handheld_end_to_end(sound_run):
    line = last_line(sound_run)
    check_line(line, trace=False)
    assert set(line["metrics"]) == {"frames_per_s", "call_ms_p95", "pose_lag_p95_ms",
                                    "device_mem_gb", "setup_s"}
    assert line["attempted"] == 30


@pytest.mark.parametrize("workload,mix,frames", [
    ("euroc_mav_wvga20.sweep", {"trace_stretch": {"first": 2, "calls": 3}}, 8),
    ("tum_fr1_vga30.occlusion",
     {"occlusion": {"first": 3, "every": 5, "frames": 2, "mean_dn": 12.0, "sigma_dn": 3.0},
      "trace_stretch": {"first": 2, "calls": 5}}, 10),
])
@pytest.mark.parametrize("trace", [False, True])
def test_mixes_end_to_end(workload, mix, frames, trace):
    res = tiny_run(workload, frames, trace=trace, mix=mix)
    line = last_line(res)
    check_line(line, trace)
    assert line["attempted"] == frames
    if trace:
        assert line["device"]["window_s"] > 0


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                        "tum_fr1_vga30.handheld", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from slam_bench import run; "
            "run.execute('tum_fr1_vga30.handheld', 1, 1.0, False, 'cpu', max_frames=1)")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


# -- faults planted in the program underneath a whole run ------------------------

def altered_descriptors(monkeypatch):
    """Every descriptor's first bit flipped where it is produced."""
    from orbslam_jpminipc_torch.ops import orb

    real = orb.descriptors_from_patches
    monkeypatch.setattr(orb, "descriptors_from_patches",
                        lambda p, a: real(p, a) ^ 1)


def ba_unchanged(monkeypatch):
    """Local BA returns the state it was given."""
    import torch
    from orbslam_jpminipc_torch.pipeline import local_mapping

    real = local_mapping.local_ba_kernel

    def unchanged(dm, kf_R, kf_t, kf_fixed, points, *a, **k):
        res = real(dm, kf_R, kf_t, kf_fixed, points, *a, **k)
        same = lambda x, like: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                               device=like.device).to(like.dtype)
        return res._replace(kf_R=same(kf_R, res.kf_R), kf_t=same(kf_t, res.kf_t),
                            points=same(points, res.points))

    monkeypatch.setattr(local_mapping, "local_ba_kernel", unchanged)


def pose_unchanged(monkeypatch):
    """The WORKING step returns the pose it started from."""
    from orbslam_jpminipc_torch.frontend.tracking import Tracker

    real = Tracker.fused_complete

    def held(self, rec):
        out = real(self, rec)
        frame = self.last_frame
        first = getattr(self, "_held_pose", None)
        if frame is not None and frame.R is not None:
            if first is None:
                self._held_pose = (frame.R.copy(), frame.t.copy())
            else:
                frame.R, frame.t = first[0].copy(), first[1].copy()
        return out

    monkeypatch.setattr(Tracker, "fused_complete", held)


def step_pose_late(monkeypatch):
    """The WORKING step reports the previous frame's pose."""
    from orbslam_jpminipc_torch.frontend.tracking import Tracker

    real = Tracker.fused_complete

    def late(self, rec):
        prev = getattr(self, "_late_pose", None)
        state, frame = real(self, rec)
        if frame is not None and frame.R is not None:
            self._late_pose = (frame.R.copy(), frame.t.copy())
            if prev is not None:
                frame.R, frame.t = prev[0].copy(), prev[1].copy()
        return state, frame

    monkeypatch.setattr(Tracker, "fused_complete", late)


def step_binding_altered(monkeypatch):
    """Every binding of the step moved to the next slice row where the step
    produces it."""
    import torch
    from orbslam_jpminipc_torch.frontend import fused_track

    real = fused_track.FusedStep.pass2

    def shifted(self, p, slc, recover):
        out = real(self, p, slc, recover)
        fb = out.feat_bind
        slot = ((fb & 0xFFFF) + 1) % self.n_map
        moved = torch.where(fb >= 0, (fb & fused_track.BIND_INLIER) | slot, fb)
        return out._replace(feat_bind=moved.to(fb.dtype))

    monkeypatch.setattr(fused_track.FusedStep, "pass2", shifted)


def ba_edge_dropped(monkeypatch):
    """The local-BA problem loses its last edge where it is assembled."""
    from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper

    real = LocalMapper.build_local_ba_problem

    def dropped(self, kf):
        prob, all_kfs, pts, obs_src, obs_idx = real(self, kf)
        n = int(np.asarray(prob.obs_valid).sum())
        if n:
            prob.obs_valid[n - 1] = False
        return prob, all_kfs, pts, obs_src, obs_idx

    monkeypatch.setattr(LocalMapper, "build_local_ba_problem", dropped)


def ba_second_stage_unchanged(monkeypatch):
    """Local BA's second stage returns the state it was given."""
    import torch
    from orbslam_jpminipc_torch.pipeline import local_mapping

    real = local_mapping.local_ba_kernel

    def unchanged(dm, kf_R, kf_t, kf_fixed, points, *a, iterations=5, **k):
        res = real(dm, kf_R, kf_t, kf_fixed, points, *a, iterations=iterations, **k)
        if iterations != 10:
            return res
        same = lambda x, like: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                               device=like.device).to(like.dtype)
        return res._replace(kf_R=same(kf_R, res.kf_R), kf_t=same(kf_t, res.kf_t),
                            points=same(points, res.points))

    monkeypatch.setattr(local_mapping, "local_ba_kernel", unchanged)


@pytest.mark.parametrize("fault,number", [
    (altered_descriptors, "desc_bits_pct"),
    (ba_unchanged, "ba_shortfall_pct"),
    (ba_second_stage_unchanged, "ba2_shortfall_pct"),
    (ba_edge_dropped, "ba_problem_diff"),
    (pose_unchanged, "traj_err_pct"),
    (step_pose_late, "step_pose_px"),
    (step_binding_altered, "step_match_bad_pct"),
])
def test_a_planted_fault_turns_correct_false(monkeypatch, sound_run, fault, number):
    assert sound_run["checks"][number]["value"] <= sound_run["checks"][number]["limit"]
    fault(monkeypatch)
    res = tiny_run("tum_fr1_vga30.handheld", 30)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_the_sound_run_is_correct(sound_run):
    assert sound_run["correct"] is True
    assert sound_run["checks"]["ba_problem_diff"]["value"] == 0.0
    assert sound_run["checks"]["ba2_shortfall_pct"]["value"] is not None


def test_the_control_and_each_fault_come_out_not_correct(sound_run):
    """Each control's readings, beside the run's other numbers, turn
    `correct` false (the relocalization faults read nothing: no
    relocalization in a tiny handheld run)."""
    limits = {k: v["limit"] for k, v in sound_run["checks"].items()}
    for name, readings in sound_run["_control"].items():
        if all(v is None for v in readings.values()):
            continue
        ok, _, _ = check.decide(dict(sound_run["_numbers"], **readings), limits)
        assert not ok, name
    ok, _, _ = check.decide({k: sound_run["_control"]["bf16"][k]
                             for k in ("kp_mismatch_pct", "desc_bits_pct")}, limits)
    assert not ok
