"""Sim3 (similarity transform) group: exp/log, compose, inverse (counterpart
of orbslam_jpminipc_tpu/geometry/sim3.py).

g2o's Sim3 type (Thirdparty/g2o/g2o/types/sim3/sim3.h, exp/log at :148),
used by the loop-closing Sim3 refinement and the essential-graph optimizer
(src/Optimizer.cc:1470-1917).

A Sim3 element is a tuple ``(s, R, t)`` acting on points by
``y = s * R @ x + t``. Tangent 7-vectors are ``[omega(3), upsilon(3), sigma]``
(rotation, translation, log-scale), g2o's ordering. All functions batch over
leading dimensions and trace under `torch.func.vmap` / `jacfwd`: no
data-dependent indexing, and every `where` has two finite arms (each
`safe_*` denominator below is there for the arm that is not taken).
"""
from __future__ import annotations

import torch

from ..solvers.linalg3 import inv3
from ..utils.device import resolve_device
from .se3 import _eye_like, exp_so3, hat, log_so3, mat_from_quat, quat_from_mat

_EPS = 1e-6


def identity(dtype=torch.float32, device=None):
    """The identity element on `device` (None: the current CUDA device)."""
    device = resolve_device(device)
    return (torch.ones((), dtype=dtype, device=device), torch.eye(3, dtype=dtype, device=device),
            torch.zeros((3,), dtype=dtype, device=device))


def _rot(R, x):
    return (R @ x[..., None])[..., 0]


def transform(s, R, t, x) -> torch.Tensor:
    """Apply (s,R,t) to points x (..., 3)."""
    return s[..., None] * _rot(R, x) + t


def compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): apply b first, then a."""
    return sa * sb, Ra @ Rb, sa[..., None] * _rot(Ra, tb) + ta


def inverse(s, R, t):
    s_inv = 1.0 / s
    R_inv = R.transpose(-1, -2)
    return s_inv, R_inv, -s_inv[..., None] * _rot(R_inv, t)


def _W_matrix(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 'left Jacobian' W with t = W @ upsilon (g2o sim3.h ctor).

    W = A*Omega + B*Omega^2 + C*I, where A, B, C depend on (theta, sigma)
    with series fallbacks near zero, branch-free."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + 1e-24)
    s = torch.exp(sigma)
    sigma2 = sigma * sigma

    small_sigma = torch.abs(sigma) < _EPS
    small_theta = theta < _EPS
    one = torch.ones_like(sigma)
    safe_sigma = torch.where(small_sigma, one, sigma)
    safe_sigma2 = torch.where(small_sigma, one, sigma2)
    safe_theta = torch.where(small_theta, one, theta)
    safe_theta2 = torch.where(small_theta, one, theta2)

    # C = (s - 1)/sigma, -> 1 as sigma -> 0
    C = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)

    # sigma ~ 0
    A_s0 = torch.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    B_s0 = torch.where(small_theta, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / torch.where(small_theta, one, theta2 * theta))

    # sigma != 0, theta ~ 0
    A_t0 = ((sigma - 1.0) * s + 1.0) / safe_sigma2
    B_t0 = ((0.5 * sigma2 - sigma + 1.0) * s - 1.0) / (safe_sigma2 * safe_sigma)

    # general case
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma2
    safe_c = torch.where(c < 1e-24, one, c)
    A_g = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_c)
    B_g = (C - ((b - 1.0) * sigma + a * theta) / safe_c) / safe_theta2

    A = torch.where(small_sigma, A_s0, torch.where(small_theta, A_t0, A_g))
    B = torch.where(small_sigma, B_s0, torch.where(small_theta, B_t0, B_g))

    Omega = hat(omega)
    return (A[..., None, None] * Omega + B[..., None, None] * (Omega @ Omega)
            + C[..., None, None] * _eye_like(Omega))


def exp7(xi: torch.Tensor):
    """Sim3 exp: 7-vector [omega, upsilon, sigma] -> (s, R, t)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), exp_so3(omega), _rot(_W_matrix(omega, sigma), upsilon)


def log7(s, R, t) -> torch.Tensor:
    """Sim3 log: (s, R, t) -> 7-vector [omega, upsilon, sigma]. The 3x3
    solve W upsilon = t is the closed-form inverse: no library call that
    checks its result on the host."""
    sigma = torch.log(s)
    omega = log_so3(R)
    upsilon = _rot(inv3(_W_matrix(omega, sigma)), t)
    return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)


def retract(s, R, t, xi, fix_scale: bool = False):
    """Left-multiplicative update exp(xi) * (s,R,t); optionally freeze scale
    (g2o VertexSim3Expmap::oplusImpl with `_fix_scale`,
    types_seven_dof_expmap.h:47-93)."""
    if fix_scale:
        xi = torch.cat([xi[..., :6], torch.zeros_like(xi[..., 6:])], dim=-1)
    ds, dR, dt = exp7(xi)
    return compose(ds, dR, dt, s, R, t)


def pack8(s, R, t) -> torch.Tensor:
    """Pack to an 8-vector [qw,qx,qy,qz, tx,ty,tz, s] for SoA storage."""
    return torch.cat([quat_from_mat(R), t, s[..., None]], dim=-1)


def unpack8(p: torch.Tensor):
    return p[..., 7], mat_from_quat(p[..., :4]), p[..., 4:7]
