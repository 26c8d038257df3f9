"""The pose LM kernel (csrc/pose_lm.cu, ops/pose_lm_cuda.py) against the
plain version, solvers/pose_opt.py:optimize_pose_plain.

Imports no JAX, so the card's tests run where the card is:
    python -m pytest tests/test_torch_pose_lm.py -m gpu -q
On the CPU: the routing to the plain version, what the wrapper refuses,
the kernel's schedule modelled in torch operations, and the tracer's
counter per call. Without a CUDA device the `gpu` tests skip.
"""
import os

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.geometry import se3
from orbslam_jpminipc_torch.ops import pose_lm_cuda
from orbslam_jpminipc_torch.solvers import pose_opt
from orbslam_jpminipc_torch.solvers.linalg3 import solve6_spd
from orbslam_jpminipc_torch.solvers.reproj import huber_weight, jacobians, residuals
from orbslam_jpminipc_torch.utils.tracing import StageTracer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)

# kernel against plain on the card: float32 sums in another order
POSE_TOL = 1e-5
GATE_REL = 1e-4   # an edge this close to its gate may fall either way


def _scene(seed, n):
    """tests/test_torch_pose_opt.py's scene: n points, a tenth of them gross
    outliers, 5 % without a match, a perturbed starting pose. Returns the
    arguments of optimize_pose as numpy arrays."""
    rng = np.random.default_rng(seed)
    R = se3.exp_so3(torch.from_numpy(rng.normal(0, 0.1, 3).astype(np.float32))).numpy()
    t = rng.normal(0, 0.1, 3).astype(np.float32)
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], 1).astype(np.float32)
    pc = xw @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:] * K4[:2] + K4[2:]).astype(np.float32)
    uv += rng.normal(0, 0.7, uv.shape).astype(np.float32)
    n_out = n // 10
    uv[:n_out] += rng.uniform(15, 40, (n_out, 2)).astype(np.float32) * rng.choice([-1, 1], (n_out, 2))
    level = rng.integers(0, 4, n)
    w = (1.0 / (1.2 ** (2 * level))).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0 = (se3.exp_so3(torch.from_numpy(rng.normal(0, 0.01, 3).astype(np.float32)))
          @ torch.from_numpy(R)).numpy()
    t0 = (t + rng.normal(0, 0.03, 3)).astype(np.float32)
    return R0, t0, xw, uv, w, valid, K4


def _tensors(args, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in args]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_rounds", [0, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_tensors_take_the_plain_version(seed, n_rounds):
    args = _tensors(_scene(seed, 300))
    ref = pose_opt.optimize_pose_plain(*args, n_rounds=n_rounds)
    assert _same(pose_lm_cuda.optimize_pose(*args, n_rounds=n_rounds), ref)
    assert _same(pose_opt.optimize_pose(*args, n_rounds=n_rounds), ref)


def _bad(name):
    args = dict(zip(("R0", "t0", "xw", "uv", "inv_sigma2", "valid", "K4"),
                    _tensors(_scene(0, 50))))
    kw = {}
    if name == "xw_float64":
        args["xw"] = args["xw"].double()
    elif name == "R0_4x4":
        args["R0"] = torch.eye(4)
    elif name == "uv_rows":
        args["uv"] = args["uv"][:-1]
    elif name == "uv_3_columns":
        args["uv"] = torch.zeros(50, 3)
    elif name == "valid_float":
        args["valid"] = args["valid"].float()
    elif name == "K4_5":
        args["K4"] = torch.zeros(5)
    elif name == "rounds_5":
        kw["n_rounds"] = 5
    elif name == "huber_negative":
        kw["use_huber_rounds"] = -1
    return args, kw


@pytest.mark.parametrize("name", ["xw_float64", "R0_4x4", "uv_rows", "uv_3_columns",
                                  "valid_float", "K4_5", "rounds_5", "huber_negative"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(name):
    args, kw = _bad(name)
    with pytest.raises(ValueError):
        pose_lm_cuda.optimize_pose(**args, **kw)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(**args, **kw)


def _kernel_schedule(R0, t0, xw, uv, w, valid, K4, use_huber_rounds=2, n_rounds=4):
    """csrc/pose_lm.cu's schedule in torch operations: one sweep an
    iteration at the candidate pose (robust chi^2, H and b with that pose's
    weights, kept on acceptance), the re-gate sharing its sweep with the
    next round's first system, a round left when it converges."""
    def sweep(R, t, inl, huber):
        e, p = residuals(R, t, xw, uv, K4)
        c = torch.sum(e * e, -1) * w
        rob = torch.where(c <= 5.991, c, 2.0 * torch.sqrt(5.991 * c) - 5.991) if huber else c
        wt = w * inl.to(w.dtype)
        if huber:
            wt = wt * huber_weight(c)
        Jp, _, _ = jacobians(R, t, xw, K4)
        Jw = Jp * wt[:, None, None]
        return (torch.einsum("nij,nik->jk", Jw, Jp), torch.einsum("nij,ni->j", Jw, e),
                torch.sum(torch.where(inl, rob, torch.zeros_like(rob))), c, p[:, 2] > 0)

    R, t, inl, eye = R0, t0, valid, torch.eye(6)
    for rnd in range(n_rounds):
        huber = rnd < use_huber_rounds
        if rnd > 0:
            c, pos = sweep(R, t, inl, huber)[3:]
            inl = valid & (c <= pose_opt._CHI2_GATES[rnd - 1]) & pos
        H, b, chi, _, _ = sweep(R, t, inl, huber)
        lam, ni = 1e-5 * torch.max(torch.abs(torch.diagonal(H))), torch.tensor(2.0)
        for _ in range(pose_opt._ROUND_ITERS[rnd]):
            delta = -solve6_spd(H + lam * eye + 1e-10 * eye, b)
            dR, dt = se3.exp_se3(delta)
            Rn, tn = se3.compose(dR, dt, R, t)
            pred = 0.5 * torch.sum(delta * (lam * delta - b))
            Hn, bn, chin, _, _ = sweep(Rn, tn, inl, huber)
            rho = (chi - chin) / torch.where(torch.abs(pred) < 1e-30, torch.tensor(1e-30), pred)
            accept = bool((rho > 0) & (chin < chi) & torch.isfinite(chin))
            converged = accept and bool(chi - chin < 1e-5 * chi)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam = torch.clamp(lam * factor if accept else lam * ni, 1e-15, 1e10)
            ni = torch.tensor(2.0) if accept else ni * 2.0
            if accept:
                R, t, chi, H, b = Rn, tn, chin, Hn, bn
            if converged:
                break
        R = se3.orthonormalize(R)
    c, pos = sweep(R, t, inl, False)[3:]
    if n_rounds:
        inl = valid & (c <= pose_opt._CHI2_GATES[n_rounds - 1]) & pos
    return R, t, inl, torch.sum(inl), torch.sum(torch.where(inl, c, torch.zeros_like(c)))


@pytest.mark.parametrize("n", [300, 2000])
@pytest.mark.parametrize("n_rounds", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_schedule_equals_the_plain_version(seed, n_rounds, n):
    """The kernel evaluates the residuals once an iteration where the plain
    version does three times; on the same operations the two schedules give
    the same bits."""
    args = _tensors(_scene(seed, n))
    assert _same(_kernel_schedule(*args, n_rounds=n_rounds),
                 pose_opt.optimize_pose_plain(*args, n_rounds=n_rounds))


def test_tracer_keeps_each_count_with_its_call(tmp_path):
    import json

    tr = StageTracer()
    tr.count("pose_lm_launches", 2)   # outside every call, detail off
    tr.detail = True
    for launches in (2, 3):
        with tr.stage("call"):
            with tr.stage("track_dispatch"):
                tr.count("pose_lm_launches", 2)
            if launches == 3:
                tr.count("pose_lm_launches")
    assert tr.counts["pose_lm_launches"] == 7
    path = tmp_path / "trace.json"
    tr.export(str(path))
    ev = json.load(open(path))["traceEvents"]
    calls = [e["args"]["id"] for e in ev if e["ph"] == "X" and e["name"] == "call"]
    per_call = {c: sum(e["args"]["n"] for e in ev if e["ph"] == "i" and e["args"]["call"] == c)
                for c in calls}
    assert sorted(per_call.values()) == [2, 3]


# ---- on the card --------------------------------------------------------------

def _near_gate(res, args, n_rounds):
    """Per row: its chi^2 at `res`'s pose lies within GATE_REL of the last
    round's gate."""
    R0, t0, xw, uv, w, valid, K = args
    e, _ = residuals(res.R, res.t, xw, uv, K)
    c = torch.sum(e * e, -1) * w
    gate = pose_opt._CHI2_GATES[n_rounds - 1]
    return (c - gate).abs() <= GATE_REL * gate


@pytest.mark.gpu
@pytest.mark.parametrize("n", [300, 1000, 2000])
@pytest.mark.parametrize("n_rounds", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain(seed, n_rounds, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _tensors(_scene(seed, n), "cuda")
    before = pose_lm_cuda.LAUNCHES
    got = pose_opt.optimize_pose(*args, n_rounds=n_rounds)   # CUDA -> the kernel
    again = pose_lm_cuda.optimize_pose(*args, n_rounds=n_rounds)
    ref = pose_opt.optimize_pose_plain(*args, n_rounds=n_rounds)
    torch.cuda.synchronize()
    assert pose_lm_cuda.LAUNCHES == before + 2
    assert _same(got, again)   # no atomics: equal bits
    assert float((got.R - ref.R).abs().max()) <= POSE_TOL
    assert float((got.t - ref.t).abs().max()) <= POSE_TOL
    differ = got.inliers != ref.inliers
    assert int(differ.sum()) <= 1
    assert bool((_near_gate(got, args, n_rounds) | ~differ).all())
    assert int(got.n_inliers) == int(got.inliers.sum())
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= int(differ.sum())
    assert got.n_inliers.dtype == torch.int64 and got.chi2.dtype == torch.float32
    if not differ.any():
        np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-4)
    # the gross outliers are rejected
    assert not got.inliers[: n // 10].any()


@pytest.mark.gpu
def test_kernel_refuses_a_strided_input_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _tensors(_scene(0, 300), "cuda")
    args[2] = args[2].t().contiguous().t()   # xw (300, 3) with column strides
    with pytest.raises(ValueError):
        pose_lm_cuda.optimize_pose(*args)


@pytest.mark.gpu
def test_one_working_dispatch_counts_its_pose_lm_launches():
    """The step's chain on the card: 2 launches a dispatch (pass 1 and pass
    2), 3 on the recovery fixture frame once its read says the recovery
    pass ran (`FusedContext.count_recovery`, as `Tracker.fused_complete`
    does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    fx = dict(np.load(FIXTURE))
    sf = dict(np.load(SLAM_FIXTURE))
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                     n_features=1000, pipelined_tracking=False)
    ctx = FusedContext(cfg, device="cuda")
    ctx.set_slice(fx["slice_buf"])
    ctx.capture()
    tracer = get_tracer()
    image = torch.as_tensor(fx["images"][0]).cuda()
    vel = (fx["vel_R0"], fx["vel_t0"])
    seeds = ((fx["R0"], fx["t0"], vel if bool(fx["has_vel0"]) else None),
             (sf["recovery_R0"], sf["recovery_t0"], vel))
    counts = []
    for R0, t0, v in seeds:
        ctx.set_pose(R0, t0, velocity=v)
        torch.cuda.synchronize()
        before, traced = pose_lm_cuda.LAUNCHES, tracer.counts["pose_lm_launches"]
        out = ctx.dispatch(image)
        if bool(out.recovered):
            ctx.count_recovery()
        counts.append((bool(out.recovered), pose_lm_cuda.LAUNCHES - before,
                       tracer.counts["pose_lm_launches"] - traced))
    assert counts == [(False, 2, 2), (True, 3, 3)]
