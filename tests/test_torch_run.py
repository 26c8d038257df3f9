"""The port's command line (`python -m orbslam_jpminipc_torch.run`, the
counterpart of orbslam_jpminipc_tpu/run.py) and `eval_torch.py` (the
counterpart of eval.py), driven on the CPU with `--device cpu` over the
`forward` trajectory, whose motion per frame does not depend on the
sequence's length: 16 frames initialize and track."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

import eval_torch
from orbslam_jpminipc_torch import run
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

torch.set_num_threads(2)

BASE = ["--dataset", "synthetic:forward", "--frames", "16", "--n-features", "600",
        "--device", "cpu"]
# eval.py's run_sequence keys with ground truth
EVAL_KEYS = {"frames", "frames_tracked", "keyframes", "points", "loops_closed", "fps",
             "ate_rmse", "extent_m", "ate_pct_extent", "kf_ate_rmse"}


def _tum_lines(path):
    rows = [line.split() for line in open(path) if line.strip()]
    assert all(len(r) == 8 for r in rows)
    return np.array(rows, np.float64)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    out, world = str(d / "kf.txt"), str(d / "w.npz")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        slam = run.main(BASE + ["--out", out, "--save-world", world, "--no-warmup"])
    return slam, out, world, printed.getvalue()


def test_run_writes_trajectory_and_ate(first_run):
    slam, out, world, text = first_run
    rows = _tum_lines(out)
    assert len(rows) == slam.n_keyframes >= 3
    assert np.all(np.diff(rows[:, 0]) > 0)
    q = rows[:, 4:8]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    assert len(slam.trajectory) > 10
    m = re.search(r"ATE RMSE \(scale-aligned\): ([0-9.]+) m over (\d+) tracked frames", text)
    assert m and float(m.group(1)) < 0.1 and int(m.group(2)) > 10, text
    assert "keyframe trajectory ->" in text and f"world -> {world}" in text


def test_run_load_world(first_run, tmp_path, capsys):
    slam, _, world, _ = first_run
    resumed = run.main(BASE + ["--out", str(tmp_path / "kf.txt"), "--load-world", world,
                               "--realtime"])
    text = capsys.readouterr().out
    assert f"resumed world: {slam.n_keyframes} KFs, {slam.n_points} points" in text
    assert resumed.n_keyframes >= slam.n_keyframes


def test_run_realtime_counts_drops(tmp_path, capsys):
    run.main(BASE + ["--out", str(tmp_path / "kf.txt"), "--realtime"])
    text = capsys.readouterr().out
    m = re.search(r"processed (\d+)/16 frames .* dropped (\d+) \(([0-9.]+)%\)", text)
    assert m, text
    done, dropped = int(m.group(1)), int(m.group(2))
    # the CPU is far slower than 30 frames a second: most frames are dropped
    assert dropped > 0 and done + dropped == 16


def test_run_settings_with_harris_score(tmp_path, capsys):
    yaml = tmp_path / "settings.yaml"
    yaml.write_text("%YAML:1.0\nCamera.fx: 500.0\nCamera.fy: 500.0\nCamera.cx: 320.0\n"
                    "Camera.cy: 240.0\nCamera.fps: 30\nORBextractor.nFeatures: 600\n"
                    "ORBextractor.nScoreType: 0\n")
    assert SlamConfig.from_yaml(str(yaml)).use_harris_score
    slam = run.main(BASE + ["--out", str(tmp_path / "kf.txt"), "--settings", str(yaml),
                            "--realtime"])
    assert slam.cfg.use_harris_score and not slam.cfg.pipelined_tracking
    assert "processed" in capsys.readouterr().out


def test_run_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no.*CUDA|current CUDA device"):
        run.main(["--dataset", "synthetic:forward", "--frames", "2"])


def test_run_viz_refused(tmp_path):
    """`--viz DIR` is refused, before any work, when DIR cannot be made (a
    file lies there); tests/test_torch_viz.py drives the option itself."""
    blocker = tmp_path / "out"
    blocker.write_text("")
    with pytest.raises(FileExistsError):
        run.main(BASE + ["--viz", str(blocker)])


def test_eval_run_sequence_keys():
    seq = SyntheticSequence(n_frames=16, trajectory="forward", seed=0, device="cpu")
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
                     max_mp=8192, local_ba_obs=8192, pipelined_tracking=False)
    vocab = load_vocabulary(eval_torch.os.path.join(
        eval_torch.REPO, "orbslam_jpminipc_torch", "data", "vocab_tree64k.npz"), device="cpu")
    gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
    res = eval_torch.run_sequence(seq, cfg, vocab, 16, gt_poses=gt, verbose=False,
                                  device="cpu")
    assert set(res) == EVAL_KEYS, set(res) ^ EVAL_KEYS
    assert res["frames"] == 16 and res["frames_tracked"] > 10 and res["loops_closed"] == 0
    assert 0 <= res["kf_ate_rmse"] < 0.1 and np.isfinite(res["ate_pct_extent"])
