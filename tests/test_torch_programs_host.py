"""The tracking host path's and loop closing's captured programs
(utils/program.py `ProgramSet`), port only.

On the CPU a program runs its function eagerly through the same copy-in and
copy-out code as on a card. Two runs give real inputs: a small `Slam`
(tests/test_torch_reloc.py's widths, a 1024-word vocabulary) over frames
0-8 of the system fixture, 2 noise frames and frames 9-11, which goes LOST
and relocalizes twice, both ladder rungs then run on its last frame; and a
`LoopCloser` over the tail of tools/loop_scene.py's small constructed loop,
which closes. Each run logs every program's first call per variant
(`CallLog`). Held, with equal bits: each logged call's outputs against its
function run directly on the same inputs, and against a copy taken at the
call (a later call must not overwrite them); extraction through its
programs against the eager extractor; the relocalization candidate program
(its RANSAC sets selected from scores drawn before it) against
`_reloc_candidate_prog` on the generator's sets from the same state, and
the initialization attempt and the Sim3 RANSAC programs likewise against
their eager compositions; and every shape the runs reached was one that
`capture_programs` names ahead of time. The `gpu`-marked tests make the
same two runs on the card, the programs captured, and hold each replay to
its eager function: equal bits, the essential graph (atomic scatter-adds)
within the larger of twice the largest difference between four eager runs
and 16 float32 ulps. Both runs draw their RANSAC sets on the CPU, so the
card's run takes the CPU run's path.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ttracking
from orbslam_jpminipc_torch.frontend.frame import Extraction, extract_eager
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.map.device_map import DeviceMap
from orbslam_jpminipc_torch.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc_torch.map.map_state import MapState
from orbslam_jpminipc_torch.pipeline.loop_closing import LoopCloser
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.solvers import initializer, pnp, sim3solver
from orbslam_jpminipc_torch.utils.program import CallLog, ProgramSet
from orbslam_jpminipc_torch.utils.tracing import get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import build_vocabulary

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False, async_mapping=False)
N_BEFORE, N_NOISE, N_AFTER = 9, 2, 3
HOST_SETS = ("track_frame", "track_local_map", "reloc_candidate", "reloc_refine",
             "init_attempt")
LOOP_SETS = ("mutual", "proj", "fuse", "sim3_opt", "sim3_ransac", "essential_graph")

sys.path.insert(0, os.path.join(REPO, "tools"))
import loop_scene  # noqa: E402


def _reloc_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_reloc_fixture", os.path.join(REPO, "tools", "make_torch_reloc_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(x):
    return pytree.tree_leaves(x)


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _signatures(slam):
    """Every program the tracker's, the extraction's and the loop closer's
    sets hold, by name."""
    names = {p.name for s in slam.tracker.programs.values() for p in s.programs.values()}
    names |= {p.name for p in slam.tracker.extraction.all_programs}
    if slam.loop_closer is not None:
        names |= {p.name for s in slam.loop_closer.programs.values()
                  for p in s.programs.values()}
    return names


def lost_run(device):
    """The small system through loss and relocalization on `device`, its
    programs taken ahead of time, every program's first call per variant
    logged; then both ladder rungs on the last frame. Returns (slam, the
    log, the names `_compile_programs` made, the candidates' inputs and
    generator states)."""
    tool = _reloc_tool()
    fx = np.load(SLAM_FIXTURE)
    ts = fx["timestamps"]
    images = np.concatenate([fx["images"][:N_BEFORE], tool.noise_frames(N_NOISE),
                             fx["images"][N_BEFORE:N_BEFORE + N_AFTER]])
    stamps = np.concatenate([ts[:N_BEFORE],
                             tool.noise_timestamps(ts[N_BEFORE - 1], ts[N_BEFORE], N_NOISE),
                             ts[N_BEFORE:N_BEFORE + N_AFTER]])
    vocab = build_vocabulary(
        np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8),
        n_words=1024, iters=3, device=device)
    slam = Slam(SlamConfig(**CFG_KW), vocab=vocab, enable_loop_closing=False, device=device)
    slam._compile_programs()
    compiled = _signatures(slam)
    tr = slam.tracker
    # the RANSAC scores drawn on the CPU: the same sets on either device
    gen = torch.Generator().manual_seed(slam.cfg.seed)
    tr.draw_scores = lambda n_hyp, n: torch.rand((n_hyp, n), generator=gen).to(device)
    candidates = []
    cut = tr._reloc_candidate

    def keep(*args):
        candidates.append((gen.get_state(), [a.clone() for a in args]))
        return cut(*args)

    tr._reloc_candidate = keep
    events = []
    tracer = get_tracer()
    orig = tracer.log
    tracer.log = lambda event, **f: (events.append({"event": event, **f}), orig(event, **f))[1]
    states, posed = [], None
    try:
        with CallLog() as log:
            for img, t in zip(images, stamps):
                state, frame = slam.process(img, float(t))
                states.append(state)
                if state == TrackState.WORKING:
                    posed = frame
            slam.finish()
            # both rungs from the last tracked frame's pose, against its
            # reference keyframe
            for radius, max_dist in ((10.0, 100), (3.0, 64)):
                tr._reloc_refine_rung(posed, tr.ref_kf, radius=radius, max_dist=max_dist)
    finally:
        del tracer.log
        del tr._reloc_candidate
    return slam, log, compiled, (gen, candidates), states


def loop_run(device):
    """A LoopCloser over the small constructed loop's tail on `device`, its
    programs taken ahead of time, every first call logged. Returns (closer,
    log, the names `capture_programs` made, the keyframe it closed on)."""
    st, info = loop_scene.build_loop_scene(MapState, "small", 0, device=device)
    cfg = SlamConfig(**info["cfg"])
    vocab = build_vocabulary(info["vocab_descriptors"], n_words=256, iters=3, seed=0,
                             device=device)
    kfdb = KeyFrameDatabase(vocab, st.max_kf, device=device)
    dm = DeviceMap(st.max_kf, st.n_feat, st.max_mp, device=device)
    dm.sync_all(st)
    loop_scene.finish_scene(st, info, kfdb,
                            lambda ids: st.update_point_attributes(ids, cfg.scale_factors, dm))
    closer = LoopCloser(cfg, st, kfdb, device=device)
    closer.dmap = dm
    closer.capture_programs()
    compiled = {p.name for s in closer.programs.values() for p in s.programs.values()}
    closed = -1
    with CallLog() as log:
        for k in info["tail"]:
            if closer.process(k):
                closed = int(k)
                break
    return closer, log, compiled, closed


@pytest.fixture(scope="module")
def lost():
    return lost_run("cpu")


@pytest.fixture(scope="module")
def loop():
    return loop_run("cpu")


def _calls(log, prefix):
    return [c for c in log.calls if c.name.startswith(prefix + "[")]


# ---- the program set ----------------------------------------------------------

def test_program_set_keeps_each_shapes_buffers():
    """One program per input shape: a set called at n1, at n2 and at n1
    again keeps both programs and their buffers, and each call's outputs
    survive the calls after it."""
    fn = lambda v, x, y: {"z": x * v + y.sum(), "n": (x > 0).sum()}
    prog = ProgramSet(fn, "cpu", "affine")
    n1 = (torch.arange(20.0), torch.ones(3))
    n2 = (torch.arange(40.0) - 4.0, torch.ones(3))
    a = prog.run(2.0, *n1)
    b = prog.run(2.0, *n2)
    c = prog.run(-1.0, *n1)
    assert [p.name for p in prog.programs.values()] == ["affine[20]", "affine[40]"]
    buffers = [p._inputs for p in prog.programs.values()]
    assert [tuple(x.shape) for x in buffers[0]] == [(20,), (3,)]
    assert [tuple(x.shape) for x in buffers[1]] == [(40,), (3,)]
    for out, v, args in ((a, 2.0, n1), (b, 2.0, n2), (c, -1.0, n1)):
        assert _equal(out, fn(v, *args))
    # a program's buffers are its own: n1's hold its last call's inputs
    assert torch.equal(buffers[0][0], n1[0]) and torch.equal(buffers[1][0], n2[0])


def test_host_programs_keep_both_feature_budgets(lost):
    """The tracker's sets hold a program at each shape the reference
    compiles: frame-to-frame tracking at n1 and n2 on both sides, the rest
    at frame n1 and n2; the run used the n1 programs and kept the others."""
    slam, *_ = lost
    n1, n2 = CFG_KW["n_features"], 2 * CFG_KW["n_features"]
    names = {k: sorted(p.name for p in s.programs.values())
             for k, s in slam.tracker.programs.items()}
    assert names["track_frame"] == sorted(
        [f"track_frame[{n1}]", f"track_frame[{n2}]", f"track_frame[{n1}x{n2}]",
         f"track_frame[{n2}x{n1}]"])
    assert names["track_local_map"] == [f"track_local_map[4096x{n2}]",
                                        f"track_local_map[4096x{n1}]"]
    assert names["reloc_refine"] == [f"reloc_refine[{n2}]", f"reloc_refine[{n2}x{n1}]"]
    assert names["reloc_candidate"] == sorted([f"reloc_candidate[256x{n1}x{n2}]",
                                               f"reloc_candidate[256x{n2}]"])
    assert names["init_attempt"] == [f"init_attempt[200x{n2}]"]
    assert sorted(slam.tracker.extraction._budgets) == [n1, n2]


# ---- the host path on its real inputs -----------------------------------------

def test_lost_run_relocalizes_through_the_programs(lost):
    slam, log, _, (_, candidates), states = lost
    lost_frames = [i for i, s in enumerate(states) if s == TrackState.LOST]
    assert lost_frames and states[-1] == TrackState.WORKING
    assert len(candidates) >= 2
    assert {c.name.split("[")[0] for c in log.calls} >= set(HOST_SETS) | {"extract"}


@pytest.mark.parametrize("name", HOST_SETS)
def test_host_program_equals_its_function(lost, name):
    """Each logged call: the outputs the caller got are unchanged by the
    calls after it, and equal the function run directly on its inputs."""
    _, log, *_ = lost
    calls = _calls(log, name)
    assert calls
    for c in calls:
        assert _equal(c.out, c.out_copy), c.name
        with torch.no_grad():
            assert _equal(c.out, c.eager(*c.inputs)), c.name


@pytest.mark.parametrize("budget", ["n1", "n2"])
def test_extraction_programs_equal_the_eager_extractor(lost, budget):
    """`Extraction` (detect, the picks, describe) against `extract_eager`
    on the frames the run extracted at each budget, and on a fixture frame
    through a fresh `Extraction`."""
    slam, log, *_ = lost
    n = CFG_KW["n_features"] * (1 if budget == "n1" else 2)
    calls = [c for c in log.calls if c.name == f"extract[{n}]"]
    assert calls
    for c in calls:
        assert _equal(c.out, c.out_copy)
        assert _equal(c.out, c.eager(*c.inputs))
    img = np.load(SLAM_FIXTURE)["images"][5]
    ex = Extraction(slam.cfg, device="cpu")
    got = ex.run(img, n)
    assert _equal(got, extract_eager(torch.from_numpy(img), slam.cfg, n))
    assert len(ex.last_fast_ok) == len(ex.programs(n)[1])


def test_cut_candidate_equals_the_one_program(lost):
    """The candidate as the tracker runs it (one program, its sets selected
    from scores drawn before the replay) against `_reloc_candidate_prog` on
    the generator's sets (`pnp.sample_minimal_sets`) from the same state:
    equal bits."""
    slam, _, _, (gen, candidates), _ = lost
    tr = slam.tracker
    ok = 0
    for state, args in candidates:
        gen.set_state(state)
        got = tr._reloc_candidate(*args)
        gen.set_state(state)
        want = ttracking._reloc_candidate_prog(
            lambda mask, n_hyp: pnp.sample_minimal_sets(mask, n_hyp, gen), *args)
        assert _equal(got, want)
        ok += bool(got[2])
    assert ok >= 2


def test_init_attempt_program_equals_its_composition(lost):
    """The initialization attempt's logged call against `_init_attempt` on
    the sets `initializer.sample_minimal_sets` draws from the same scores:
    equal bits, and the attempt ran as a program of the n2 shape."""
    slam, log, *_ = lost
    calls = _calls(log, "init_attempt")
    n2 = 2 * CFG_KW["n_features"]
    assert [c.name for c in calls] == [f"init_attempt[200x{n2}]"]
    scores, *args = calls[0].inputs
    want = ttracking._init_attempt(
        lambda mask, n_hyp: initializer.select_minimal_sets(scores, mask, 8), *args)
    assert _equal(calls[0].out, want)


def test_sim3_ransac_program_equals_its_composition(loop):
    """The Sim3 RANSAC's logged call against `solve_sim3` on the sets its
    scores select: equal bits; the replayed-set route gives the same."""
    _, log, *_ = loop
    (call,) = _calls(log, "lc_sim3_ransac")
    scores, p1, p2, uv1, uv2, mask, *rest = call.inputs
    sets = initializer.select_minimal_sets(scores, mask, 3)
    want = sim3solver.solve_sim3(sets, p1, p2, uv1, uv2, mask, *rest)
    assert _equal(call.out, want)
    again = initializer.select_minimal_sets(
        initializer.scores_for_sets(sets, mask.shape[0]), mask, 3)
    assert torch.equal(again, sets)


def test_the_run_reached_only_shapes_captured_ahead(lost):
    """`_compile_programs` names every program the run then called: the
    dummy inputs have the real calls' shapes and dtypes."""
    slam, _, compiled, *_ = lost
    assert _signatures(slam) == compiled


# ---- loop closing on its real inputs ------------------------------------------

def test_loop_run_closes_through_the_programs(loop):
    closer, log, compiled, closed = loop
    assert closed == 8
    assert {c.name.split("[")[0] for c in log.calls} == {f"lc_{s}" for s in LOOP_SETS[:5]} | {
        "essential_graph"}
    # every shape reached was captured ahead
    assert {p.name for s in closer.programs.values() for p in s.programs.values()} == compiled


@pytest.mark.parametrize("name", LOOP_SETS)
def test_loop_program_equals_its_function(loop, name):
    _, log, *_ = loop
    prefix = "essential_graph" if name == "essential_graph" else f"lc_{name}"
    calls = _calls(log, prefix)
    assert calls
    for c in calls:
        assert _equal(c.out, c.out_copy), c.name
        with torch.no_grad():
            assert _equal(c.out, c.eager(*c.inputs)), c.name


# ---- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _spread(runs):
    """The largest difference between any two of `runs`, leaf by leaf."""
    leaves = [_leaves(r) for r in runs]
    return [max(float((a[i].double() - b[i].double()).abs().max())
                for a in leaves for b in leaves) for i in range(len(leaves[0]))]


# the essential graph's atomic scatter-adds: captured within the larger of
# twice the largest difference between four eager runs and 16 float32 ulps
# of the leaf's largest entry (chip_smoke.py's bound and its reason)
EG_EAGER_RUNS, EG_SPREAD_FACTOR, EG_ULPS = 4, 2.0, 16


def _hold_on_card(log):
    rows = []
    for c in log.calls:
        assert _equal(c.out, c.out_copy), c.name
        eg = c.name.startswith("essential")
        with torch.no_grad():
            eager = [c.eager(*c.inputs) for _ in range(EG_EAGER_RUNS if eg else 1)]
        if eg:
            spread = _spread(eager)
            diff = _spread([c.out, eager[0]])
            ulps = [EG_ULPS * torch.finfo(torch.float32).eps * float(x.abs().max())
                    for x in _leaves(eager[0])]
            assert all(d <= max(EG_SPREAD_FACTOR * s, u)
                       for d, s, u in zip(diff, spread, ulps)), (c.name, diff, spread)
        else:
            assert _equal(c.out, eager[0]), c.name
        rows.append(c.name)
    return rows


@pytest.mark.gpu
def test_host_programs_captured_equal_eager_on_the_card(card):
    slam, log, compiled, _, states = lost_run(card)
    assert TrackState.LOST in states and states[-1] == TrackState.WORKING, states
    assert _signatures(slam) == compiled
    names = _hold_on_card(log)
    assert {n.split("[")[0] for n in names} >= set(HOST_SETS) | {"extract"}


@pytest.mark.gpu
def test_loop_programs_captured_equal_eager_on_the_card(card):
    closer, log, compiled, closed = loop_run(card)
    assert closed == 8
    names = _hold_on_card(log)
    assert {n.split("[")[0] for n in names} == {f"lc_{s}" for s in LOOP_SETS[:5]} | {
        "essential_graph"}
