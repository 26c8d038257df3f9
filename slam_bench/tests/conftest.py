"""The benchmark's own tests: `python -m pytest slam_bench/tests -q` from the
repository's root. They run on the CPU at a tiny test-only size; a test
that needs the card carries the `chip` marker and decides inside the test
whether there is one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a camera a quarter of the TUM one and small capacities: a CPU frame
# then takes about a second
TINY_CONFIG = {
    "Camera.width": 320, "Camera.height": 240, "Camera.fx": 258.7, "Camera.fy": 258.2,
    "Camera.cx": 159.3, "Camera.cy": 127.7, "ORBextractor.nFeatures": 400,
    "port": {"max_kf": 48, "max_mp": 4096, "local_ba_kf": 8, "local_ba_fixed": 8,
             "local_ba_points": 1024, "local_ba_obs": 4096, "pipelined_tracking": True,
             "pipeline_depth": 6, "async_mapping": True, "loop_closing": True},
}
# a shorter period: the tiny runs see initialization, keyframes and local BA
TINY_MIX = {"period": 100}
TINY_SEED = 2 ** 31 + 77
# every third frame's step and every local BA sampled for the checks
TINY_EVERY = {"frame": 3, "ba": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips where there is none)")


def tiny_run(workload, frames, trace=False, control=False, mix=None, seed=TINY_SEED):
    from slam_bench import run

    return run.execute(workload, seed, 1e9, trace, "cpu", control=control,
                       config_over=TINY_CONFIG, max_frames=frames, warmup=False,
                       mix_over={**TINY_MIX, **(mix or {})}, every=TINY_EVERY)


@pytest.fixture(scope="session")
def sound_run():
    """A tiny handheld run that initializes and inserts keyframes, with the
    control's readings."""
    return tiny_run("tum_fr1_vga30.handheld", 30, control=True)
