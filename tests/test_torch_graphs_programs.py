"""The port's compiled-program model: captured programs (utils/program.py),
the WORKING step as programs cut at its host reads, `Slam.warmup` with a
vocabulary, and the command line's `--no-warmup`.

On the CPU a program runs its function eagerly, through the same copy-in and
copy-out code as on a card. So here the tests hold the copies (outputs of one
call survive the next), the state the step feeds forward against the eager
step's, and `Slam.warmup()` of the default constructor call leaving a fresh
system. The `gpu`-marked tests capture on the card and hold the replays to
equal bits against the eager runs, the local-BA program (its gathers from
the map mirror inside it) to the eager stage, and the pipelined dispatch
(the step's graphs as one chain whose branches the device decides) to the
synchronous step. The warmed system against the recorded outcome is
tests/test_torch_graphs.py's."""
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
from orbslam_jpminipc_torch.utils import graph_chain
from orbslam_jpminipc_torch.utils.program import Program
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary
from test_torch_graphs import _fresh_state

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "orbslam_jpminipc_torch", "data")
FIXTURE = os.path.join(DATA, "track_fixture_xyz.npz")
SMALL = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
             n_features=300, n_levels=4, pipelined_tracking=False)


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


# ---- Slam.warmup with a vocabulary --------------------------------------------

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
def test_capture_survives_the_collection_of_older_graphs(card):
    """A graph of another program whose last holder is a cycle that becomes
    garbage during a capture (an older system's programs): with the
    collector set to run at every allocation the capture still completes,
    as destroying a graph inside it would invalidate it, and replays."""
    import gc

    x, y = torch.tensor([1.0, -2.0, 3.0]), torch.tensor([0.5, 0.5, -4.0])
    older = Program(_affine, card, "older", copy_in=True, copy_out=True, keep_graph=True)
    older.run(2.0, x, y)
    box = {"captured": older._graphs.pop(2.0)}
    del older

    def fn(v, a, b):
        if box and torch.cuda.is_current_stream_capturing():
            cycle = [box.pop("captured")]
            cycle.append(cycle)
            del cycle
            [[] for _ in range(100)]   # allocations: the collector's chances
        return _affine(v, a, b)

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        prog = Program(fn, card, "newer", copy_in=True, copy_out=True)
        first = prog.run(2.0, x, y)
        again = prog.run(2.0, x, y)
    finally:
        gc.set_threshold(*threshold)
    assert not box
    for out in (first, again):
        for k, want in _affine(2.0, x.cuda(), y.cuda()).items():
            assert torch.equal(out[k], want), k


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
    """A local-BA stage as the map mirror's captured program (the
    observations' pixels and weights gathered from the mirror inside it)
    against the stage's function run eagerly, on a problem of the mapper's
    capacities: chi2 within the spread of the card's atomics (index_add_),
    the same outlier flags but a few."""
    from orbslam_jpminipc_torch.map import device_map as dmap

    prob = _ba_problem()
    K, O = prob.kf_R.shape[0], prob.obs_kf.shape[0]
    # each observation a feature row of its keyframe in the mirror, level 0
    kf = prob.obs_kf.numpy()
    feat, count = np.zeros(O, np.int64), np.zeros(K, np.int64)
    for o, k in enumerate(kf):
        feat[o], count[k] = count[k], count[k] + 1
    xy = np.zeros((K, int(count.max()), 2), np.float32)
    xy[kf, feat] = prob.obs_uv.numpy()
    dm = dmap.DeviceMap(K, xy.shape[1], 16, device=card)
    dm.kf_xy.copy_(torch.from_numpy(xy))
    args = (prob.kf_R, prob.kf_t, prob.kf_fixed, prob.points, prob.point_valid, prob.obs_kf,
            prob.obs_pt, feat, kf, prob.obs_valid, prob.K4, np.ones(8, np.float32))
    inputs = [x.to(card) for x in dmap._INPUTS["local_ba"](*args)]
    eager = dm.programs["local_ba"].fn
    for iterations in (5, 10):
        got = dmap.local_ba_kernel(dm, *args, iterations=iterations)
        want = eager(iterations, *inputs)
        assert float(want.chi2) < 0.05 * float(eager(0, *inputs).chi2)
        assert abs(float(got.chi2) - float(want.chi2)) <= 1e-3 * abs(float(want.chi2))
        assert int((got.obs_outlier != want.obs_outlier).sum()) <= 0.002 * O
    assert dm.programs["local_ba"].programs and all(
        p.variants == (5, 10) for p in dm.programs["local_ba"].programs.values())


@pytest.mark.gpu
def test_dispatch_equals_the_synchronous_step_on_the_card(card, fixture):
    """The step's chain (`FusedContext.dispatch`) against its segments with
    their host reads (`track`) on the tracking fixture's frames fed forward,
    a low-texture frame (levels take the slow pick) and a frame from a
    perturbed pose (the recovery pass): equal bits, one FAST launch and one
    branch kernel per branch a frame, and no host synchronisation."""
    fx = fixture
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000)
    flat = np.full_like(fx["images"][0], 128)
    flat[192:288, 272:368] = fx["images"][0][192:288, 272:368]
    turn = np.array([[np.cos(0.14), -np.sin(0.14), 0], [np.sin(0.14), np.cos(0.14), 0],
                     [0, 0, 1]], np.float32)
    frames = [(img, None) for img in fx["images"]] + [(flat, None), (fx["images"][0], turn)]
    runs = []
    for name in ("track", "dispatch"):
        ctx = tfused.FusedContext(cfg, device=card)
        ctx.set_slice(fx["slice_buf"])
        ctx.capture()
        ctx.set_pose(fx["R0"], fx["t0"], velocity=(fx["vel_R0"], fx["vel_t0"]))
        outs, slow, recovered = [], 0, 0
        for img, rot in frames:
            if rot is not None:
                ctx.set_pose(rot @ fx["R0"], fx["t0"] + np.array([0.1, 0, 0], np.float32))
            img = torch.as_tensor(img).to(card)
            n_fast, n_branch = fast_cuda.LAUNCHES, graph_chain.LAUNCHES
            if name == "track":
                out = ctx.track(img)
                slow += not all(ctx.last_fast_ok)
                recovered += ctx.last_pass1_inliers < 20
            else:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = ctx.dispatch(img)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                assert graph_chain.LAUNCHES == n_branch + len(ctx.step.plan) + 1
            assert fast_cuda.LAUNCHES == n_fast + 1
            outs.append(_fields(out))
        runs.append(outs)
        if name == "track":
            assert slow >= 1 and recovered >= 1   # both arms of both branches ran
    for want, got in zip(*runs):
        for k, v in want.items():
            assert torch.equal(got[k], v), k
