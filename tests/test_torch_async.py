"""The PyTorch port's asynchronous mapping queue (`cfg.async_mapping`),
driven through the default constructor call `Slam(cfg, vocab=v)`: loop
closing on, so every keyframe queues eleven stages, the mapper's ten and
then "loop".

Which stage runs on which frame depends on whether a device program has
finished, so the reference's run cannot be replayed frame by frame; the
run is held to outcomes and to the queue's invariants instead (on the CPU
every queued read is done at once, so this run is the fastest-draining
one): initialised on the frame the synchronous system initialises on,
WORKING on every frame after, at least one WORKING frame that inserts no
keyframe, every queued keyframe's stages run at most once and all of them
run or are taken out by the InterruptBA rules, the queue never deeper than
`n + (n - 4) * (p - 1)` right after a keyframe arrives with `p` keyframes
queued (`n = 11` stages; an arrival cancels every BA that has not
started, `StageQueueAudit` says how), one `loop_detect` for every "loop" stage that ran and no
loop closed (as the reference on this sequence), nothing pending after
`finish()`, the keyframe
database in step with the map, and the keyframe trajectory's ATE against
ground truth at most 6 mm (the synchronous reference's is below 1 mm on
these frames, tests/test_torch_slam.py, plus the 5 mm margin of the card's
run).

The InterruptBA bookkeeping and the tick's stopping rules are tested on a
scripted queue: a `Slam` whose mapper's stages and whose loop closing are
replaced by a recorder.
"""
import os

import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.frame import Frame
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.io.trajectory import ate_rmse
from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils import host
from orbslam_jpminipc_torch.utils.tracing import StageQueueAudit, get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import vocab_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False, async_mapping=True)
N_FRAMES = 14
ATE_BOUND = 6e-3
STAGES = Slam.STAGES
BA = ("ba_d", "ba_m", "ba2_d", "ba2_m")
# where each launch stage keeps its queued read: (attribute, index, host half)
HANDLE_AT = {"triangulate_d": ("_tri_pending", 2, "triangulate_m"),
             "fuse_d": ("_fuse_pending", 4, "fuse_m"),
             "ba_d": ("_ba_pending", 7, "ba_m"),
             "ba2_d": ("_ba2_pending", 6, "ba2_m")}


@pytest.fixture(scope="module")
def vocab():
    v = build_vocabulary(np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8),
                         n_words=1024, iters=3)
    return vocab_from_numpy(v, device="cpu")


@pytest.fixture(scope="module")
def run(vocab):
    fx = np.load(SLAM_FIXTURE)
    slam = Slam(SlamConfig(**CFG_KW), vocab=vocab, device="cpu")   # loop closing on
    get_tracer().reset()
    audit = StageQueueAudit(slam)
    mapper = slam.mapper
    kf_frames, handles, aborts = [], [], []
    insert, run_stage, ba_abort = mapper.insert_keyframe, mapper.run_stage, mapper.ba_abort
    mapper.insert_keyframe = lambda frame: (kf_frames.append(frame.frame_id), insert(frame))[1]

    def spy_stage(kf, stage):
        run_stage(kf, stage)
        if stage in HANDLE_AT:
            attr, i, merge = HANDLE_AT[stage]
            p = getattr(mapper, attr)
            if p is not None:
                handles.append((stage, type(p[i]), p[i].done(), mapper.stage_ready(kf, merge)))

    def spy_abort(kf):
        aborts.append((kf, mapper._ba_stage1 is not None and mapper._ba_stage1[0] == kf))
        ba_abort(kf)
        assert mapper._ba_stage1 is None

    mapper.run_stage, mapper.ba_abort = spy_stage, spy_abort
    hard_drains = []
    drain = slam._drain_mapping_hard

    def spy_drain():
        drain()
        hard_drains.append((slam.frame_count - 1, list(slam.pending)))

    slam._drain_mapping_hard = spy_drain
    states = []
    for i in range(N_FRAMES):
        state, _ = slam.process(fx["images"][i], float(fx["timestamps"][i]))
        states.append(state.value)
    slam.finish()
    return dict(slam=slam, audit=audit, states=states, kf_frames=kf_frames, handles=handles,
                aborts=aborts, hard_drains=hard_drains, fx=fx, stages=get_tracer().summary())


def test_async_run_initialises_like_the_synchronous_one_and_stays_working(run):
    fx = run["fx"]
    sync = Slam(SlamConfig(**dict(CFG_KW, async_mapping=False)), device="cpu")
    sync_states = [sync.process(fx["images"][i], float(fx["timestamps"][i]))[0].value
                   for i in range(5)]
    working = TrackState.WORKING.value
    first = run["states"].index(working)
    assert first == sync_states.index(working)
    assert all(s == working for s in run["states"][first:])


def test_some_working_frames_insert_no_keyframe(run):
    working = [i for i, s in enumerate(run["states"]) if s == TrackState.WORKING.value]
    other = [i for i in working[1:] if i not in run["kf_frames"]]
    assert len(other) >= 1, "the mapper-busy gate refused no keyframe"
    assert len(run["kf_frames"]) >= 3
    # with synchronous mapping every one of these frames makes a keyframe
    assert len(run["kf_frames"]) < len(working) - 1


def test_stage_queue_invariants(run):
    slam, audit = run["slam"], run["audit"]
    assert slam.pending == []
    audit.check(STAGES)
    counts = audit.counts()
    assert counts["keyframes_queued"] == len(run["kf_frames"])
    n, p = len(STAGES), counts["max_keyframes_queued_at_once"]
    assert 1 <= p and counts["max_depth"] <= n + (n - 4) * (p - 1)
    assert audit.arrivals and all(d <= n + (n - 4) * (q - 1) for d, q in audit.arrivals)
    assert STAGES == LocalMapper.STAGES + ("loop",) and len(STAGES) == 11
    for e in audit.entries:
        assert e["queued"] == list(STAGES)  # "loop" after the mapper's stages
        order = [s for s in e["ran"] if s in STAGES]
        assert order == [s for s in STAGES if s in order], e  # in the pipeline's order
    assert counts["stages_run"] + counts["stages_skipped_culled"] > 5 * len(run["kf_frames"])


def test_the_loop_stage_runs_once_per_keyframe_and_closes_no_loop(run):
    slam, audit = run["slam"], run["audit"]
    assert slam.loop_closer is not None and slam.loop_closer.dmap is slam.mapper.dmap
    loops = [e["ran"].count("loop") + e["skipped"].count("loop") for e in audit.entries]
    assert loops == [1] * len(audit.entries)           # never taken out, never twice
    ran = sum(e["ran"].count("loop") for e in audit.entries)
    assert ran >= 3
    assert run["stages"]["loop_closing"]["count"] == ran
    assert run["stages"]["loop_detect"]["count"] == ran  # traced once per stage that ran
    assert slam.n_loops_closed == 0
    assert all(not edges for edges in slam.map.kf_loop_edges)


def test_hard_drain_aborts_the_second_ba_stage_through_ba_abort(run):
    """On these frames the inlier count dips below 0.7 of its peak while a
    keyframe's stages are queued: the System drains the queue hard, which
    is what calls `LocalMapper.ba_abort`."""
    assert run["hard_drains"] and all(left == [] for _, left in run["hard_drains"])
    assert run["audit"].counts()["ba_aborted"] >= 1
    # every abort found stage 1's result waiting and wrote it back
    assert run["aborts"] and all(found for _, found in run["aborts"])
    aborted = [e for e in run["audit"].entries if "ba_abort" in e["ran"]]
    assert aborted and all("ba2_d" not in e["ran"] and "ba2_m" not in e["ran"] and
                           "ba_m" in e["ran"] for e in aborted)


def test_launch_stages_queue_their_read_where_stage_ready_looks(run):
    seen = {stage for stage, *_ in run["handles"]}
    assert seen == set(HANDLE_AT)
    for stage, kind, done, ready in run["handles"]:
        assert kind is host.AsyncFetch and done and ready, stage


def test_keyframe_database_and_trajectory_after_finish(run):
    slam, fx = run["slam"], run["fx"]
    np.testing.assert_array_equal(slam.kfdb.present, slam.map.kf_valid)
    kft = slam.keyframe_trajectory()
    index = {round(float(ts), 6): i for i, ts in enumerate(fx["timestamps"])}
    est = np.stack([-R.T @ t for _, R, t in kft]).astype(np.float64)
    gi = [index[round(ts, 6)] for ts, _, _ in kft]
    gt = np.stack([-fx["gt_R"][i].T @ fx["gt_t"][i] for i in gi]).astype(np.float64)
    ate = ate_rmse(est, gt)
    print(f"async keyframe ATE {ate:.6f} over {len(kft)} keyframes (bound {ATE_BOUND})")
    assert np.isfinite(ate) and ate <= ATE_BOUND
    assert slam.mapper._attrs_inflight is None


# ---- scripted queue ---------------------------------------------------------

class _Scripted:
    """A Slam whose mapper records the stages instead of running them."""

    def __init__(self, ready=lambda kf, stage: True):
        self.slam = slam = Slam(SlamConfig(**CFG_KW), device="cpu")
        self.ran = []
        self.next_kf = 0
        slam.mapper.run_stage = lambda kf, stage: self.ran.append((kf, stage))
        slam.mapper.stage_ready = ready
        slam.mapper.insert_keyframe = self._insert
        slam.mapper.drain_attrs = lambda force=True: self.drains.append(len(self.ran))
        slam._loop_close = lambda kf: self.ran.append((kf, "loop"))
        self.drains = []
        slam.tracker.refresh_fused_slice = lambda: None

    def _insert(self, frame):
        kf = self.next_kf
        self.next_kf += 1
        self.slam.map.kf_valid[kf] = True
        return kf

    def keyframe(self):
        self.slam._on_new_keyframe(Frame(0, 0.0, n_feat=4))

    def stages_of(self, kf):
        return [s for k, s in self.ran if k == kf]


def test_new_keyframe_queues_every_stage_and_sets_the_gate():
    s = _Scripted()
    assert not s.slam._mapper_busy()
    s.keyframe()
    assert s.slam.pending == [(0, list(STAGES))] and s.slam._mapper_busy()
    assert s.slam.tracker.ref_kf == 0 and s.ran == []


def test_new_keyframe_cancels_a_ba_that_has_not_started():
    s = _Scripted()
    s.keyframe()
    for _ in range(3):                      # cull_points, triangulate_d, triangulate_m
        s.slam._run_pending_stage()
    s.keyframe()
    assert s.slam.pending[0] == (0, ["fuse_d", "fuse_m", "cull_kf", "loop"])
    assert s.slam.pending[1] == (1, list(STAGES))
    s.slam.finish()
    assert not any(st in BA or st == "ba_abort" for st in s.stages_of(0))
    assert s.stages_of(1) == list(STAGES) and s.slam.pending == []


def test_new_keyframe_aborts_a_ba_between_its_stages():
    s = _Scripted()
    s.keyframe()
    for _ in range(7):                      # ... ba_d, ba_m
        s.slam._run_pending_stage()
    assert s.slam.pending[0][1][0] == "ba2_d"
    s.keyframe()
    assert s.slam.pending[0] == (0, ["ba_abort", "cull_kf", "loop"])
    s.slam.finish()
    assert s.stages_of(0) == list(STAGES[:7]) + ["ba_abort", "cull_kf", "loop"]


def test_new_keyframe_leaves_a_launched_second_stage_alone():
    s = _Scripted()
    s.keyframe()
    for _ in range(8):                      # ... ba2_d
        s.slam._run_pending_stage()
    s.keyframe()
    assert s.slam.pending[0] == (0, ["ba2_m", "cull_kf", "loop"])


def test_hard_drain_inserts_ba_abort_after_ba_m_when_stage_one_is_queued():
    s = _Scripted()
    s.keyframe()
    for _ in range(5):                      # up to fuse_m; ba_d still queued
        s.slam._run_pending_stage()
    s.slam._drain_mapping_hard()
    assert s.slam.pending == []
    assert s.stages_of(0) == list(STAGES[:5]) + ["ba_d", "ba_m", "ba_abort", "cull_kf", "loop"]


def test_hard_drain_puts_ba_abort_in_place_when_stage_one_has_run():
    s = _Scripted()
    s.keyframe()
    for _ in range(7):
        s.slam._run_pending_stage()
    s.slam._drain_mapping_hard()
    assert s.stages_of(0) == list(STAGES[:7]) + ["ba_abort", "cull_kf", "loop"]


def test_hard_drain_works_off_every_queued_keyframe():
    s = _Scripted()
    s.keyframe()
    s.keyframe()                            # cancels kf 0's BA
    s.slam._drain_mapping_hard()
    assert s.slam.pending == []
    assert s.stages_of(0) == [st for st in STAGES if st not in BA]
    assert s.stages_of(1) == list(STAGES[:5]) + ["ba_d", "ba_m", "ba_abort", "cull_kf", "loop"]


def test_the_loop_stage_is_always_ready_and_applies_the_deferred_attributes_first():
    """Detection reads host point attributes: the stage applies a deferred
    attribute writeback before it runs, and never waits to be ready."""
    s = _Scripted()
    s.keyframe()
    assert LocalMapper.stage_ready(s.slam.mapper, 0, "loop")   # the mapper's own answer
    s.slam.pending[0][1][:] = ["loop"]
    s.slam._mapping_tick()
    assert s.ran == [(0, "loop")] and s.drains == [0] and s.slam.pending == []


def test_tick_stops_at_a_stage_that_is_not_ready():
    s = _Scripted(ready=lambda kf, stage: stage != "triangulate_m")
    s.keyframe()
    s.slam._mapping_tick()
    assert s.stages_of(0) == ["cull_points", "triangulate_d"]
    s.slam._mapping_tick()                  # still not ready: nothing runs, nothing waits
    assert s.stages_of(0) == ["cull_points", "triangulate_d"]
    assert s.slam.pending[0][1][0] == "triangulate_m"


def test_tick_launches_at_most_two_programs_and_runs_at_most_eight_stages():
    s = _Scripted()
    s.keyframe()
    s.slam._mapping_tick()
    assert s.stages_of(0) == ["cull_points", "triangulate_d", "triangulate_m", "fuse_d"]
    s.slam._mapping_tick()
    assert s.stages_of(0)[4:] == ["fuse_m", "ba_d", "ba_m", "ba2_d"]
    s.slam.pending[0][1][:] = ["cull_kf"] * 12     # host-only stages: the cap of 8
    s.slam._mapping_tick()
    assert len(s.slam.pending[0][1]) == 4


def test_stages_of_a_culled_keyframe_are_dropped_unrun():
    s = _Scripted(ready=lambda kf, stage: False)   # never asked for a culled keyframe
    s.keyframe()
    s.slam.map.kf_valid[0] = False
    s.slam._mapping_tick()                  # pops up to the second launch stage
    assert s.ran == [] and s.slam.pending[0][1] == list(STAGES[4:])
    s.slam.finish()
    assert s.ran == [] and s.slam.pending == []


def test_synchronous_mapping_never_queues():
    slam = Slam(SlamConfig(**dict(CFG_KW, async_mapping=False)), device="cpu")
    assert slam.tracker.mapper_busy is None and slam.pending == []


@pytest.mark.parametrize("busy,n_inliers,expect", [
    (False, 80, True),    # idle mapper: tracking degraded -> keyframe
    (True, 80, False),    # busy mapper: deferred
    (True, 40, True),     # busy, but tracking decays hard: keyframe anyway
    (True, 95, False),    # not degraded: no keyframe whatever the mapper does
    (False, 95, False)])
def test_keyframe_decision_asks_the_mapper_busy_gate(busy, n_inliers, expect):
    slam = Slam(SlamConfig(**CFG_KW), device="cpu")
    tr = slam.tracker
    slam.map.kf_valid[0] = True
    slam.map.kf_point[0, :100] = np.arange(100)
    tr.ref_kf, tr.n_inliers, tr.last_kf_frame_id = 0, n_inliers, 0
    if busy:
        slam.pending.append((0, ["cull_kf"]))
    assert tr.mapper_busy() is busy
    assert tr._need_new_keyframe(Frame(3, 0.1, n_feat=4)) is expect


# ---- queued reads -----------------------------------------------------------

def test_fetch_async_on_cpu_tensors_is_done_at_once_and_equals_fetch():
    gen = torch.Generator().manual_seed(0)
    tensors = (torch.rand((5, 3), generator=gen), torch.arange(7, dtype=torch.int32),
               torch.tensor([True, False]), torch.randint(0, 255, (4, 32), dtype=torch.uint8),
               torch.tensor(3, dtype=torch.int64))
    reads = host.get_tracer().counts["reads"]
    h = host.fetch_async(*tensors)
    assert isinstance(h, host.AsyncFetch) and h.done()
    got, ref = h.result(), host.fetch(*tensors)
    assert host.get_tracer().counts["reads"] == reads   # a CPU tensor costs no read
    assert len(got) == len(ref) == len(tensors)
    for g, r, t in zip(got, ref, tensors):
        assert g.dtype == r.dtype and g.shape == r.shape == tuple(t.shape)
        np.testing.assert_array_equal(g, r)
    tensors[0].zero_()
    assert got[0].any()               # a copy, not a view
    assert h.result() is got          # taken once


def test_stage_ready_asks_only_the_pending_read_of_that_keyframe():
    class Handle:
        def __init__(self, done):
            self._done = done

        def done(self):
            return self._done

    mapper = Slam(SlamConfig(**CFG_KW), device="cpu").mapper
    for launch, (attr, i, merge) in HANDLE_AT.items():
        assert mapper.stage_ready(3, merge) and mapper.stage_ready(3, launch)
        for done in (False, True):
            pending = [3] + [None] * 8
            pending[i] = Handle(done)
            setattr(mapper, attr, tuple(pending))
            assert mapper.stage_ready(3, merge) is done
            assert mapper.stage_ready(4, merge)    # another keyframe's stage does not wait
            assert mapper.stage_ready(3, launch)
        setattr(mapper, attr, None)
    assert mapper.stage_ready(3, "cull_points") and mapper.stage_ready(3, "cull_kf")
