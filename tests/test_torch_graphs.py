"""The port's compiled-program model: captured programs (utils/program.py),
the WORKING step as programs cut at its host reads, `Slam.warmup`, and the
command line's `--no-warmup`.

On the CPU a program runs its function eagerly, through the same copy-in and
copy-out code as on a card. So here the tests hold the copies (outputs of one
call survive the next), the state the step feeds forward against the eager
step's, `Slam.warmup()` leaving a fresh system, and a warmed system against
the JAX package's recorded outcome on frames 0-27 of the system fixture (the
fixture's shipping config: ~5 min on the CPU). The `gpu`-marked tests capture
on the card and hold the replays to equal bits against the eager runs."""
import json
import os

import numpy as np
import pytest
import torch

import eval_torch
from orbslam_jpminipc_torch import run
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import fused_track as tfused
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
from orbslam_jpminipc_torch.ops import fast_cuda
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.solvers import ba
from orbslam_jpminipc_torch.utils.program import Program
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "orbslam_jpminipc_torch", "data")
FIXTURE = os.path.join(DATA, "track_fixture_xyz.npz")
SLAM_FIXTURE = os.path.join(DATA, "slam_fixture_xyz.npz")
SMALL = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
             n_features=300, n_levels=4, pipelined_tracking=False)
# the system against the reference's recorded outcome (tests/test_torch_slam.py's
# bounds): states and keyframe counts equal, points within 1 %, camera centres
# within 1e-3 (the map's median depth is 1)
POINTS_REL = 0.01
CENTRE_TOL = 1e-3


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def _small_slice(fx, m=512):
    buf = fx["slice_buf"]
    rows = np.nonzero(buf[:, 7] > 0)[0][:m]
    return np.ascontiguousarray(buf[rows])


def _fields(out):
    d = {k: getattr(out, k) for k in out._fields if k != "feats"}
    d.update({f"feats.{k}": getattr(out.feats, k) for k in out.feats._fields})
    return d


# ---- the program holder ------------------------------------------------------

def _affine(variant, x, y):
    """A small program: outputs of several dtypes and ranks."""
    z = x * variant + y
    return {"z": z, "sum": z.sum(), "pos": z > 0, "idx": torch.argsort(z)}


def test_program_copies_outputs_and_inputs_on_the_cpu():
    """With copy-in and copy-out, call k's outputs are unchanged after call
    k+1, and changing the caller's tensors after a call changes nothing."""
    prog = Program(_affine, "cpu", "affine", copy_in=True, copy_out=True)
    x = torch.tensor([1.0, -2.0, 3.0])
    y = torch.tensor([0.5, 0.5, -4.0])
    first = prog.run(2.0, x, y)
    want = {k: v.clone() for k, v in _affine(2.0, x, y).items()}
    x.add_(10.0)
    second = prog.run(-1.0, x, y)
    for k, v in want.items():
        assert first[k].dtype == v.dtype and first[k].shape == v.shape, k
        assert torch.equal(first[k], v), k
    for k, v in _affine(-1.0, x, y).items():
        assert torch.equal(second[k], v), k
    # one byte buffer holds every output of a call
    ptrs = {t.untyped_storage().data_ptr() for t in first.values()}
    assert len(ptrs) == 1
    with pytest.raises(ValueError, match="buffer"):
        prog.run(1.0, torch.zeros(4), torch.zeros(4))


def test_program_in_place_reads_the_callers_tensors():
    """Without copy-in a program reads its inputs where they are: a state
    buffer updated in place between calls is seen by the next call."""
    state = torch.tensor([1.0, 2.0])
    prog = Program(lambda v, s: s * 2.0, "cpu", "double")
    a = prog.run(None, state)
    state.mul_(3.0)
    b = prog.run(None, state)
    assert a.tolist() == [2.0, 4.0] and b.tolist() == [6.0, 12.0]
    prog.capture(None, state)   # nothing to capture on the CPU
    assert prog.variants == ()


# ---- the WORKING step as programs -------------------------------------------

def test_context_state_fed_forward_equals_the_eager_step(fixture):
    """Ten fixture frames (subsampled to the small config) through the
    context's programs and through the eager step with the state fed forward
    by hand (the context before its programs): every output and the state
    after each step equal bits; each step's outputs survive the next step."""
    buf = _small_slice(fixture)
    cfg = SlamConfig(**SMALL)
    ctx = tfused.FusedContext(cfg, n_map=512, device="cpu")
    vel = (fixture["vel_R0"], fixture["vel_t0"])
    ctx.set_pose(fixture["R0"], fixture["t0"], velocity=vel)
    ctx.set_slice(buf)
    state = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
    kept = []
    for k in range(10):
        img = np.ascontiguousarray(fixture["images"][k][::2, ::2])
        eager = ctx.step(torch.from_numpy(img), *state, ctx.slice)
        got = ctx.track(img)
        want = _fields(eager)
        for name, v in _fields(got).items():
            assert torch.equal(v, want[name]), (k, name)
        for a, b in zip((ctx.R, ctx.t, ctx.vel_R, ctx.vel_t), (eager.R, eager.t,
                                                               eager.vel_R, eager.vel_t)):
            assert torch.equal(a, b), k
        assert bool(ctx.has_vel)
        if ctx.last_pass1_inliers >= 20:   # no recovery pass: n_inl1 is pass 1's
            assert ctx.last_pass1_inliers == int(eager.n_inl1)
        kept.append((got, {n: v.clone() for n, v in _fields(got).items()}))
        state = [eager.R, eager.t, eager.vel_R, eager.vel_t, torch.tensor(True)]
    assert int(kept[-1][0].n_inl2) >= 20   # the steps really tracked
    for got, copy in kept:
        for name, v in _fields(got).items():
            assert torch.equal(v, copy[name]), name


def test_context_buffers_are_written_in_place(fixture):
    """`set_pose`, `load_slice`, `capture` and the step write the fixed
    buffers and never rebind them; `ready` and `invalidate` are host flags;
    a slice of another row count is refused."""
    buf = _small_slice(fixture)
    ctx = tfused.FusedContext(SlamConfig(**SMALL), n_map=512, device="cpu")
    ptrs = [x.data_ptr() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel,
                                   *ctx._slice)]
    assert not ctx.ready and ctx.slice is None
    ctx.set_pose(fixture["R0"], fixture["t0"], velocity=(fixture["vel_R0"], fixture["vel_t0"]))
    ctx.set_slice(buf)
    assert ctx.ready and ctx.epoch == 1
    before = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
    ctx.capture()   # the chain on a blank frame; the state is put back
    for a, b in zip((ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel), before):
        assert torch.equal(a, b)
    ctx.track(np.ascontiguousarray(fixture["images"][0][::2, ::2]))
    assert not torch.equal(ctx.R, before[0])
    ctx.invalidate()
    assert not ctx.ready and ctx.slice is None and ctx.epoch == 2
    with pytest.raises(ValueError, match="slice"):
        ctx.set_slice(buf[:100])
    assert [x.data_ptr() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel,
                                   *ctx._slice)] == ptrs
    np.testing.assert_array_equal(ctx._slice.xyz.numpy(), buf[:, 0:3])


# ---- Slam.warmup --------------------------------------------------------------

def _fresh_state(slam):
    """What a freshly constructed system starts from."""
    tr = slam.tracker
    st = slam.map
    out = {
        "frame_count": slam.frame_count, "trajectory": len(slam.trajectory),
        "pending": len(slam.pending), "n_keyframes": slam.n_keyframes,
        "n_points": slam.n_points, "next_kf_id": st.next_kf_id,
        "n_loops_closed": slam.n_loops_closed, "last_result": slam._last_result[0],
        "inlier_peak": slam._inlier_peak, "tracker_state": tr.state,
        "velocity": tr.velocity, "last_frame": tr.last_frame, "ref_kf": tr.ref_kf,
        "last_kf_frame_id": tr.last_kf_frame_id, "last_reloc_frame_id": tr.last_reloc_frame_id,
        "n_inliers": tr.n_inliers, "generator": tr.generator.get_state().tolist(),
        "fused_ready": tr.fused.ready, "slice_ids": tr.fused.slice_ids.tolist(),
        "probation": slam.mapper.probation, "dmap_version": slam.mapper.dmap.version,
        "kf_valid": st.kf_valid.tolist(), "mp_valid": int(st.mp_valid.sum()),
    }
    if slam.kfdb is not None:
        out["kfdb_present"] = slam.kfdb.present.tolist()
        out["kfdb_n"] = slam.kfdb.bow_n.tolist()
    if slam.loop_closer is not None:
        lc = slam.loop_closer
        out.update(loop_groups=lc.consistent_groups, last_loop=lc.last_loop_kf_id,
                   loop_generator=lc.generator.get_state().tolist())
    return out


@pytest.fixture(scope="module")
def warmed():
    """The system fixture's config (the reference's recorded run), warmed."""
    sf = dict(np.load(SLAM_FIXTURE))
    cfg = SlamConfig(**json.loads(str(sf["meta"]))["config"])
    slam = Slam(cfg, vocab=None, device="cpu")
    drove = []
    process = slam.process
    slam.process = lambda img, ts=0.0: (drove.append(ts), process(img, ts))[1]
    slam.warmup()
    del slam.process
    return slam, cfg, sf, drove


def test_warmup_leaves_a_fresh_system(warmed):
    slam, cfg, _, drove = warmed
    assert len(drove) > 12   # phase 2 drove frames through the system
    assert _fresh_state(slam) == _fresh_state(Slam(cfg, vocab=None, device="cpu"))


def test_warmup_with_a_vocabulary_leaves_a_fresh_system():
    """The default constructor call (asynchronous mapping, loop closing on):
    phase 2 relocalizes after its noise frame, then maps; afterwards the
    database, the closer and the draws are a fresh system's."""
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
                     max_mp=8192, local_ba_obs=8192, pipelined_tracking=False)
    vocab = load_vocabulary(os.path.join(DATA, "vocab_synthetic.npz"), device="cpu")
    slam = Slam(cfg, vocab=vocab, device="cpu")
    states = []
    process = slam.process
    slam.process = lambda img, ts=0.0: (lambda r: (states.append(r[0]), r)[1])(process(img, ts))
    slam.warmup()
    del slam.process
    lost = states.index(TrackState.LOST)
    assert TrackState.WORKING in states[lost:]   # relocalized within the warmup
    assert _fresh_state(slam) == _fresh_state(Slam(cfg, vocab=vocab, device="cpu"))


def test_warmed_system_matches_recorded_reference(warmed):
    """A warmed system over frames 0-27 of the system fixture (the
    reference's initialization sets injected) against the JAX package's
    recorded outcome: states and keyframe counts per frame, points, camera
    centres."""
    slam, _, sf, _ = warmed
    sets = iter(torch.from_numpy(s) for s in sf["init_sets"])
    slam.tracker.sampler = lambda mask, n_hyp: next(sets)
    states, nkf, npt, poses = [], [], [], []
    for img, ts in zip(sf["images"], sf["timestamps"]):
        state, frame = slam.process(img, float(ts))
        states.append(state.value)
        nkf.append(slam.n_keyframes)
        npt.append(slam.n_points)
        pose = np.full((3, 4), np.nan, np.float32)
        if frame is not None and frame.R is not None:
            pose[:, :3], pose[:, 3] = frame.R, frame.t
        poses.append(pose)
    slam.finish()
    assert states == sf["states"].tolist()
    assert nkf == sf["n_keyframes_per_frame"].tolist()
    rpt = sf["n_points_per_frame"]
    assert np.all(np.abs(np.array(npt) - rpt) <= POINTS_REL * rpt), (npt, rpt)
    assert slam.n_keyframes == int(sf["n_keyframes"])
    assert abs(slam.n_points - int(sf["n_points"])) <= POINTS_REL * int(sf["n_points"])
    poses, ref = np.stack(poses), sf["poses"]
    has = ~np.isnan(ref[:, 0, 0])
    np.testing.assert_array_equal(~np.isnan(poses[:, 0, 0]), has)
    for g, r in zip(poses[has], ref[has]):
        np.testing.assert_allclose(-g[:, :3].T @ g[:, 3], -r[:, :3].T @ r[:, 3], atol=CENTRE_TOL)


# ---- the command line ---------------------------------------------------------

@pytest.mark.parametrize("flag", [[], ["--no-warmup"]])
def test_run_warms_up_unless_told_not_to(monkeypatch, tmp_path, flag):
    calls = []
    monkeypatch.setattr(Slam, "warmup", lambda self: calls.append(self.frame_count))
    slam = run.main(["--dataset", "synthetic:forward", "--frames", "2", "--n-features", "300",
                     "--device", "cpu", "--out", str(tmp_path / "kf.txt"), *flag])
    assert calls == ([] if flag else [0]) and slam.frame_count == 2


@pytest.mark.parametrize("warmup", [True, False])
def test_eval_run_sequence_honours_warmup(monkeypatch, warmup):
    calls = []
    monkeypatch.setattr(Slam, "warmup", lambda self: calls.append(self.frame_count))
    seq = SyntheticSequence(n_frames=2, trajectory="forward", seed=0, device="cpu")
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=300,
                     pipelined_tracking=False)
    res = eval_torch.run_sequence(seq, cfg, None, 2, verbose=False, warmup=warmup,
                                  device="cpu")
    assert calls == ([0] if warmup else []) and res["frames"] == 2


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_program_captures_and_replays_on_the_card(card):
    """A captured program replays its variant's graph: outputs equal to the
    eager function, copies that survive the next replay, one capture per
    variant."""
    prog = Program(_affine, card, "affine", copy_in=True, copy_out=True)
    x = torch.tensor([1.0, -2.0, 3.0])
    y = torch.tensor([0.5, 0.5, -4.0])
    first = prog.run(2.0, x, y)
    second = prog.run(-1.0, x.cuda(), y.cuda())
    again = prog.run(2.0, x, y)
    assert set(prog.variants) == {2.0, -1.0}
    for out, v in ((first, 2.0), (second, -1.0), (again, 2.0)):
        for k, want in _affine(v, x.cuda(), y.cuda()).items():
            assert torch.equal(out[k], want), (v, k)


@pytest.mark.gpu
def test_captured_step_equals_eager_and_counts_fast_replays(card, fixture):
    """The context's captured step against the eager step on the card over
    the fixture's frames: equal bits; one FAST launch a frame, counted at
    the replays."""
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000,
                     pipelined_tracking=False)
    ctx = tfused.FusedContext(cfg, device=card)
    ctx.set_slice(fixture["slice_buf"])
    ctx.capture()
    ctx.set_pose(fixture["R0"], fixture["t0"], velocity=(fixture["vel_R0"], fixture["vel_t0"]))
    state = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
    for img in fixture["images"]:
        img = torch.as_tensor(img).to(card)
        eager = ctx.step(img, *state, ctx.slice)
        n0 = fast_cuda.LAUNCHES
        got = ctx.track(img)
        assert fast_cuda.LAUNCHES == n0 + 1
        want = _fields(eager)
        for name, v in _fields(got).items():
            assert torch.equal(v, want[name]), name
        state = [eager.R, eager.t, eager.vel_R, eager.vel_t, torch.ones((), dtype=torch.bool,
                                                                         device=card)]


def _ba_problem(K=48, P=2048, O=8192, seed=0):
    """A local-BA problem of the mapper's capacities with a solution: K
    cameras along x looking down z at P points 3-5 deep, O observations of
    them with 0.5 px noise, free cameras and points moved off the truth."""
    rng = np.random.default_rng(seed)
    t = np.zeros((K, 3), np.float32)
    t[:, 0] = -np.linspace(-0.5, 0.5, K)
    pts = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P),
                    rng.uniform(3, 5, P)], axis=1).astype(np.float32)
    kf, pt = rng.integers(0, K, O), rng.integers(0, P, O)
    xc = pts[pt] + t[kf]
    uv = (500.0 * xc[:, :2] / xc[:, 2:] + np.array([320.0, 240.0])
          + rng.normal(0, 0.5, (O, 2))).astype(np.float32)
    fixed = np.arange(K) < 2
    t0 = t + np.where(fixed[:, None], 0, rng.normal(0, 0.01, (K, 3))).astype(np.float32)
    p0 = pts + rng.normal(0, 0.01, (P, 3)).astype(np.float32)
    T = torch.from_numpy
    return ba.BAProblem(
        kf_R=torch.eye(3).repeat(K, 1, 1), kf_t=T(t0), kf_fixed=T(fixed), points=T(p0),
        point_valid=torch.ones(P, dtype=torch.bool), obs_kf=T(kf), obs_pt=T(pt),
        obs_uv=T(uv), obs_w=torch.ones(O), obs_valid=torch.ones(O, dtype=torch.bool),
        K4=torch.tensor([500.0, 500.0, 320.0, 240.0]))


@pytest.mark.gpu
def test_local_ba_program_matches_eager_on_the_card(card):
    """A local-BA stage as a captured program against the eager solve on a
    problem of the mapper's capacities: chi2 within the spread of the
    card's atomics (index_add_), the same outlier flags but a few."""
    from orbslam_jpminipc_torch.map.device_map import local_ba_program

    prob = ba.BAProblem(*(x.to(card) for x in _ba_problem()))
    prog = local_ba_program(card)
    for iterations in (5, 10):
        got = prog.run(iterations, prob)
        want = ba.bundle_adjust(prob, iterations=iterations)
        assert float(want.chi2) < 0.05 * float(ba.bundle_adjust(prob, iterations=0).chi2)
        assert abs(float(got.chi2) - float(want.chi2)) <= 1e-3 * abs(float(want.chi2))
        assert int((got.obs_outlier != want.obs_outlier).sum()) <= 0.002 * prob.obs_kf.shape[0]
