"""The port's command line (`python -m orbslam_jpminipc_torch.run`, the
counterpart of orbslam_jpminipc_tpu/run.py), driven on the CPU with
`--device cpu` over the `forward` trajectory, whose motion per frame does
not depend on the sequence's length: 16 frames initialize and track. Here
the saved and resumed world and the refusals; the realtime and settings
runs and `eval_torch.py` are tests/test_torch_run_warmed.py's (a file of
its own, so the two share the run's workers)."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch import run

torch.set_num_threads(2)

BASE = ["--dataset", "synthetic:forward", "--frames", "16", "--n-features", "600",
        "--device", "cpu"]


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
