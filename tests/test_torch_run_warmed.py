"""The port's command line (`python -m orbslam_jpminipc_torch.run`) with its
warmup on, `--realtime` and `--settings`, and `eval_torch.py` (the
counterpart of eval.py), driven on the CPU with `--device cpu` over the
`forward` trajectory, whose motion per frame does not depend on the
sequence's length: 16 frames initialize and track; and the command line's
options against the JAX package's `run.py` (each option's default, type
and action; `--device` the one addition). The saved and resumed world and
the refusals are tests/test_torch_run.py's.

This file's count of test ids steers the tier-1 run: pytest-xdist's
`--dist loadfile` hands out the files with the most ids first, and the
warmed command-line runs here take ~8 min on the CPU. With a few ids the
file would start last and stretch the run by minutes;
`test_command_line_keeps_the_reference_option`, one case an option of the
reference's command line (REF_OPTIONS), makes it start among the first.
Merging those cases undoes that: check the run's wall time if you do."""
import argparse
import re
from unittest import mock

import numpy as np
import pytest
import torch

import eval_torch
from orbslam_jpminipc_torch import run
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary
from test_torch_run import BASE

torch.set_num_threads(2)

# the JAX package's run.py options
REF_OPTIONS = ("--dataset", "--settings", "--vocab", "--frames", "--n-features", "--out",
               "--save-world", "--load-world", "--no-loop-closing", "--realtime", "--seed",
               "--no-warmup", "--viz")
# eval.py's run_sequence keys with ground truth
EVAL_KEYS = {"frames", "frames_tracked", "keyframes", "points", "loops_closed", "fps",
             "ate_rmse", "extent_m", "ate_pct_extent", "kf_ate_rmse"}


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
    # the command line runs the package's default frame loop, pipelined
    assert slam.cfg.use_harris_score and slam.cfg.pipelined_tracking
    assert "processed" in capsys.readouterr().out


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


class _Parsed(Exception):
    pass


def _options(main) -> dict:
    """The options a command line's `main` declares: flag -> (dest,
    default, type, action class), read from its parser, which is stopped
    at `parse_args` before any work."""
    box = {}

    def grab(self, args=None, namespace=None):
        box["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            main([])
    return {flag: (a.dest, a.default, a.type, type(a).__name__)
            for a in box["parser"]._actions for flag in a.option_strings if flag != "-h"
            and flag != "--help"}


@pytest.fixture(scope="module")
def options():
    from orbslam_jpminipc_tpu import run as jrun

    return _options(jrun.main), _options(run.main)


@pytest.mark.parametrize("flag", REF_OPTIONS)
def test_command_line_keeps_the_reference_option(options, flag):
    ref, port = options
    assert flag in ref, flag
    assert port.get(flag) == ref[flag]


def test_command_line_adds_only_the_device(options):
    ref, port = options
    assert set(ref) == set(REF_OPTIONS)
    assert set(port) - set(ref) == {"--device"} and port["--device"][1] is None
