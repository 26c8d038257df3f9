"""The readers of the program's detail-mode totals (`step_event_ms`,
`event_idle_pct`, `host_wait_ms_per_call`, `mapping_self_ms_per_kf`) on a
hand-built `RunRecord`, and None where those totals are absent (a run with
the tracer's detail mode off, or on the CPU)."""
import json

import pytest

from slam_bench.metrics import load
from slam_bench.session import RunRecord

from .conftest import ROOT

CONFIG = json.loads((ROOT / "slam_bench/configs/tum_fr1_vga30.json").read_text())
NAMES = ["step_event_ms", "event_idle_pct", "host_wait_ms_per_call", "mapping_self_ms_per_kf"]

# the program's detail-mode totals over a window: 500 calls, 25 keyframes
DETAIL_SPANS = {
    "call": (16.0, 500), "mapping": (1.5, 40), "mapping_hard_drain": (0.5, 3),
    "self.mapping": (1.2, 40), "self.mapping_hard_drain": (0.1, 3),
    "waited.mapping": (0.3, 12), "waited.mapping_hard_drain": (0.2, 3),
    "wait.track": (1.0, 60), "wait.ba_m_read": (0.25, 10), "waited.call": (1.25, 70),
    "device.busy": (12.0, 2000), "device.step": (13.5, 480), "device.tri[2048]": (0.5, 30),
    "idle.harness": (1.0, 480), "idle.track": (2.0, 500), "idle.mapping": (1.0, 300),
}
DETAIL_COUNTS = {"frames": 500, "working": 480, "lost": 0, "keyframes": 25}


def test_detail_readers_on_a_fixture():
    run = RunRecord(spans=DETAIL_SPANS, counts=DETAIL_COUNTS, trace=None, config=CONFIG)
    want = {
        "step_event_ms": 13.5 / 480 * 1e3,
        "event_idle_pct": 100.0 * 4.0 / 16.0,
        "host_wait_ms_per_call": 1.25 / 500 * 1e3,
        "mapping_self_ms_per_kf": (2.0 - 0.5) / 25 * 1e3,
    }
    for name, value in want.items():
        assert load(name).read(run) == pytest.approx(value), name


@pytest.mark.parametrize("name", NAMES)
def test_detail_readers_return_nothing_without_their_totals(name):
    plain = {k: v for k, v in DETAIL_SPANS.items()
             if not k.startswith(("device.", "idle.", "wait.", "waited.", "self."))}
    run = RunRecord(spans=plain, counts=DETAIL_COUNTS, trace=None, config=CONFIG)
    assert load(name).read(run) is None
    empty = RunRecord(spans={}, counts={"frames": 0, "keyframes": 0}, trace={}, config=CONFIG)
    assert load(name).read(empty) is None


@pytest.mark.parametrize("name", NAMES)
def test_detail_readers_declare_what_a_per_layer_entry_would_say(name):
    r = load(name)
    assert r.NAME == name and r.SOURCE == "program_span"
    assert r.MOVES in ("frames_per_s", "call_ms_p95") and r.UNIT in ("ms", "%")
