"""The port's tracer (`utils/tracing.py`) on the CPU, with no `Slam`: the
span tree of detail mode (ids, parents, call ids, self time), timed waits
credited to the innermost span and every open one, the card's intervals
from a fake event source with set timestamps (busy, idle gaps put down to
the innermost span at their middle, `harness` between calls), the Chrome
trace `export` writes, and that with `detail` off nothing of it is made."""
import contextlib
import json

import pytest
import torch

from orbslam_jpminipc_torch.utils import host, tracing
from orbslam_jpminipc_torch.utils.tracing import StageTracer


class FakeClock:
    """The card's side with set timestamps: `record()` hands out numbered
    events, `times[ev]` is set by the test, an event is done once it has a
    time, and the anchor lies at host time `anchor_at`."""

    def __init__(self, anchor_at=0):
        self.anchor_at = anchor_at
        self.anchors = 0
        self.recorded = 0
        self.times = {}
        self.released = []

    def anchor(self):
        self.anchors += 1
        return self.anchor_at

    def record(self):
        self.recorded += 1
        return self.recorded

    def done(self, ev):
        return ev in self.times

    def host_ns(self, ev):
        return self.times[ev]

    def release(self, *evs):
        self.released += evs

    def capturing(self):
        return False

    def sync(self):
        pass


@pytest.fixture
def now(monkeypatch):
    """The host clock the tracer reads, set by the test (ns)."""
    t = [0]
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: t[0])
    monkeypatch.setattr(tracing, "perf_counter", lambda: t[0] * 1e-9)
    return t


def detailed(clock=None):
    tr = StageTracer(clock=clock or FakeClock())
    tr.detail = True
    return tr


def span(tr, now, name, t0, t1, body=None):
    now[0] = t0
    with tr.stage(name):
        if body is not None:
            body()
        now[0] = t1


def test_span_ids_parents_and_call_ids(now):
    tr = detailed()

    def call_body():
        span(tr, now, "track", 11, 20, lambda: span(tr, now, "track_pull", 12, 15))
        span(tr, now, "mapping", 21, 30)

    span(tr, now, "call", 10, 40, call_body)
    span(tr, now, "call", 50, 60, lambda: span(tr, now, "track", 51, 59))
    span(tr, now, "mapping", 70, 80)          # outside a call: call id 0
    rec = {(r[0], r[4]): r for r in tr.records}
    call1, call2 = rec[("call", 10)], rec[("call", 50)]
    assert call1[2] == 0 and call1[3] == call1[1]
    assert rec[("track", 11)][2] == call1[1] and rec[("mapping", 21)][2] == call1[1]
    assert rec[("track_pull", 12)][2] == rec[("track", 11)][1]
    assert {r[3] for r in tr.records if 10 <= r[4] < 40} == {call1[1]}
    assert rec[("track", 51)][3] == call2[1] != call1[1]
    assert rec[("mapping", 70)][2:4] == (0, 0)
    assert len({r[1] for r in tr.records}) == len(tr.records) == 7
    # records close in time order; the stack is empty again
    assert [r[5] for r in tr.records] == sorted(r[5] for r in tr.records)
    assert not tr._stack
    assert tr.counts["call"] == 2 and tr.counts["track"] == 2


def test_self_time_is_the_duration_less_the_children(now):
    tr = detailed()

    def call_body():
        span(tr, now, "track", 10, 40, lambda: span(tr, now, "track_pull", 20, 30))
        span(tr, now, "mapping", 50, 60)

    span(tr, now, "call", 0, 100, call_body)
    assert tr.totals["call"] == pytest.approx(100e-9)
    assert tr.totals["self.call"] == pytest.approx(60e-9)
    assert tr.totals["self.track"] == pytest.approx(20e-9)
    assert tr.totals["self.track_pull"] == pytest.approx(10e-9)
    call = next(r for r in tr.records if r[0] == "call")
    assert call[6] == 40                     # children's time
    # the books of one call: the self times add up to the call
    selfs = sum(r[5] - r[4] - r[6] for r in tr.records if r[3] == call[1])
    assert selfs == call[5] - call[4]


def test_waits_go_to_the_innermost_span_and_every_open_one(now):
    tr = detailed()

    def read():
        tr.note_wait(22, 27)

    def mapping():
        span(tr, now, "ba_m_read", 21, 30, read)
        tr.note_wait(31, 33)                 # in mapping itself

    span(tr, now, "call", 0, 100, lambda: span(tr, now, "mapping", 20, 40, mapping))
    tr.note_wait(200, 204)                   # between calls
    assert tr.totals["wait.ba_m_read"] == pytest.approx(5e-9)
    assert tr.totals["wait.mapping"] == pytest.approx(2e-9)
    assert tr.totals["wait.harness"] == pytest.approx(4e-9)
    assert tr.totals["waited.ba_m_read"] == pytest.approx(5e-9)
    assert tr.totals["waited.mapping"] == pytest.approx(7e-9)
    assert tr.totals["waited.call"] == pytest.approx(7e-9)
    assert "wait.call" not in tr.totals
    own = {r[0]: r[7] for r in tr.records}
    assert own == {"ba_m_read": 5, "mapping": 2, "call": 0}
    # mapping's host work: its time less what it waited for
    assert tr.totals["mapping"] - tr.totals["waited.mapping"] == pytest.approx(13e-9)


def test_idle_gaps_are_put_down_to_the_innermost_span_at_their_middle(now):
    clock = FakeClock(anchor_at=0)
    tr = detailed(clock)
    assert clock.anchors == 1
    launches = {}

    def launch(name, dev):
        b = tr.launch_begin()
        tr.launch_end(b, name)
        launches[name] = (b, b + 1, dev)

    def land(name):
        b, e, (t0, t1) = launches[name]
        clock.times[b], clock.times[e] = t0, t1

    def call1():
        span(tr, now, "track", 12, 20, lambda: launch("step", (15, 40)))
        span(tr, now, "mapping", 20, 60, lambda: launch("tri", (50, 55)))
        land("step")

    span(tr, now, "call", 10, 70, call1)
    # the step resolved at the call's close; the triangulation had not landed
    assert tr.pending == 1 and tr.totals["device.step"] == pytest.approx(25e-9)
    land("tri")

    def call2():
        span(tr, now, "track", 101, 110, lambda: launch("step2", (120, 130)))
        land("step2")
        span(tr, now, "mapping", 130, 140)

    span(tr, now, "call", 100, 150, call2)
    assert tr.pending == 0
    # anchor 0 -> 15: middle 7.5, before the first call; 40 -> 50: middle 45
    # inside mapping (closed by then); 55 -> 120: middle 87.5, between calls
    assert tr.totals["idle.harness"] == pytest.approx((15 + 65) * 1e-9)
    assert tr.counts["idle.harness"] == 2
    assert tr.totals["idle.mapping"] == pytest.approx(10e-9)
    assert tr.totals["device.busy"] == pytest.approx(40e-9)
    assert tr.counts["device.busy"] == 3
    assert tr.totals["device.tri"] == pytest.approx(5e-9) and tr.counts["device.tri"] == 1
    # each interval keeps the span that launched it; events go back to the pool
    spans = {r[1]: r[0] for r in tr.records}
    assert [(i[2], spans[i[3]]) for i in tr.intervals] == [
        ("step", "track"), ("tri", "mapping"), ("step2", "track")]
    assert sorted(clock.released) == list(range(1, 7))


def test_a_gap_under_an_open_span_and_reset_keeps_the_flag(now):
    clock = FakeClock(anchor_at=5)
    tr = detailed(clock)

    def body():
        b = tr.launch_begin()
        tr.launch_end(b, "ba")
        clock.times[b], clock.times[b + 1] = 30, 35
        span(tr, now, "ba_m_read", 40, 45)   # resolves while mapping is open

    span(tr, now, "mapping", 10, 50, body)
    assert tr.totals["idle.mapping"] == pytest.approx(25e-9)
    b = tr.launch_begin()
    tr.launch_end(b, "ba")
    tr.reset()
    assert tr.detail and clock.anchors == 2 and tr.pending == 0
    assert not tr.totals and not tr.records and not tr.intervals


def test_export_writes_a_chrome_trace(now, tmp_path):
    clock = FakeClock()
    tr = detailed(clock)

    def body():
        b = tr.launch_begin()
        tr.launch_end(b, "step")
        clock.times[b], clock.times[b + 1] = 2000, 9000
        span(tr, now, "track", 1000, 3000)

    span(tr, now, "call", 500, 10000, body)
    out = tmp_path / "trace.json"
    tr.export(str(out))
    trace = json.loads(out.read_text())
    ev = trace["traceEvents"]
    spans = [e for e in ev if e["ph"] == "X" and e["tid"] == 1]
    card = [e for e in ev if e["ph"] == "X" and e["tid"] == 2]
    assert {e["name"] for e in spans} == {"call", "track"}
    call = next(e for e in spans if e["name"] == "call")
    assert call["ts"] == 0.5 and call["dur"] == 9.5 and call["args"]["self_us"] == 7.5
    assert card == [{"name": "step", "ph": "X", "pid": 1, "tid": 2, "ts": 2.0, "dur": 7.0,
                     "args": {"span": call["args"]["id"]}}]
    names = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert {"host", "card"} <= names


def test_with_detail_off_no_event_stack_entry_or_range_is_made(now, monkeypatch):
    ranges = []

    class Range:
        def __init__(self, name):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "record_function", Range)
    monkeypatch.setattr(tracing, "_profiling", lambda: True)
    clock = FakeClock()
    tr = StageTracer(clock=clock)
    seen = []
    now[0] = 0
    with tr.stage("call"):
        now[0] = 4
        with tr.stage("track"):
            seen.append(len(tr._stack))
            now[0] = 7
    assert seen == [0] and not tr.records and tr.pending == 0
    assert clock.anchors == clock.recorded == 0 and ranges == []
    assert tr.totals == {"call": pytest.approx(7e-9), "track": pytest.approx(3e-9)}
    assert dict(tr.counts) == {"call": 1, "track": 1}
    assert set(tr.samples) == {"call", "track"}
    # the same spans in detail mode open their profiler ranges as well
    tr.detail = True
    with tr.stage("call"):
        with tr.stage("track"):
            seen.append(len(tr._stack))
    assert seen == [0, 2] and ranges == ["slam.call", "slam.track"]
    tr.detail = False
    tr.reset()
    assert clock.anchors == 1


def test_host_reads_on_cpu_count_nothing_and_wait_for_nothing(monkeypatch):
    tr = detailed()
    monkeypatch.setattr(host, "_tracer", tr)
    t = (torch.arange(5), torch.ones(3))
    host.fetch(*t)
    host.fetch_async(*t).result()
    assert tr.counts["reads"] == 0 and not any(k.startswith("wait") for k in tr.totals)


def test_the_gap_across_a_profilers_teardown_counts_nowhere(now, monkeypatch):
    profiling = [True]
    monkeypatch.setattr(tracing, "record_function", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "_profiling", lambda: profiling[0])
    clock = FakeClock(anchor_at=0)
    tr = detailed(clock)

    def body():
        b = tr.launch_begin()
        tr.launch_end(b, "step")

    span(tr, now, "call", 10, 40, body)      # profiled; lands after the call
    assert tr.pending == 1
    clock.times[1], clock.times[2] = 20, 30
    profiling[0] = False                     # the profiler's teardown, 40 -> 5000
    clock.anchor_at = 5000
    span(tr, now, "call", 5000, 5100, body)
    assert clock.anchors == 2 and tr.pending == 1
    assert tr.totals["device.step"] == pytest.approx(10e-9)
    idle = {k: v for k, v in tr.totals.items() if k.startswith("idle.")}
    assert idle == {"idle.call": pytest.approx(20e-9)}          # 0 -> 20 only


def test_detail_mode_without_a_card_records_no_interval(now, monkeypatch):
    """The real event clock where there is no card (as on the CPU): no
    anchor, no event, and a profiler's stop resolves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the clock anchors on it")
    profiling = [True]
    monkeypatch.setattr(tracing, "record_function", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "_profiling", lambda: profiling[0])
    tr = StageTracer()
    tr.detail = True
    assert tr.launch_begin() is None
    span(tr, now, "call", 0, 10)
    profiling[0] = False
    span(tr, now, "call", 20, 30)
    assert tr.pending == 0 and not tr.intervals and tr.clock.anchor_ns is None
    assert tr.counts["call"] == 2
