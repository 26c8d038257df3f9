"""One camera's pose from fixed map points, plain PyTorch: the pose that
minimises the information-weighted squared reprojection error of its
matches, as the last round of ORB-SLAM's PoseOptimization does
(Optimizer.cc:154-285: the robust kernel dropped, inliers only), solved by
Levenberg-Marquardt to convergence. Written from those equations with no
code of the system under test.

A match is a map point x (world), the keypoint uv it was bound to, the
keypoint's information weight w (1 / sigma^2 of its level) and the two
descriptors that were compared. World -> camera: p = R x + t; the step acts
on the left, T <- exp(xi) T, xi = (omega, upsilon).
"""
from __future__ import annotations

import numpy as np
import torch

from .ba import _exp, _hat, _project

CHI2 = 5.991        # the 2-dof 95 % gate of a monocular observation
TH_HIGH = 100       # ORBmatcher::TH_HIGH, the search-by-projection distance


def solve(xw, uv, w, R0, t0, K4, iterations: int = 50, dtype=torch.float64):
    """(R, t) as float64 numpy arrays, from the start (R0, t0). In a 16-bit
    `dtype` (the control) every intermediate is rounded to it, the 6x6
    solve itself running on the rounded values in float32."""
    low = dtype in (torch.bfloat16, torch.float16)
    work = torch.float32 if low else dtype
    Q = (lambda x: x.to(dtype).to(torch.float32)) if low else (lambda x: x)
    f = lambda a: Q(torch.as_tensor(np.asarray(a, np.float64)).to(work))
    X, UV, W, K = f(xw), f(uv), f(w), f(K4)
    R, t = f(R0), f(t0)

    def cost(R, t):
        p = Q(X @ R.T + t)
        proj, iz = _project(p, K)
        e = Q(UV - Q(proj))
        return Q((W * (e * e).sum(-1)).sum()), e, p, Q(iz)

    c, e, p, iz = cost(R, t)
    lam = nu = None
    I6 = torch.eye(6, dtype=work)
    for _ in range(iterations):
        fx, fy = K[0], K[1]
        zr = torch.zeros_like(iz)
        Jpi = Q(torch.stack([torch.stack([fx * iz, zr, -fx * p[:, 0] * iz * iz], -1),
                             torch.stack([zr, fy * iz, -fy * p[:, 1] * iz * iz], -1)], -2))
        # e = uv - pi(p): de/dp = -Jpi; dp/domega = -[p]x, dp/dupsilon = I
        J = Q(torch.cat([Jpi @ _hat(p), -Jpi], -1))
        H = Q(torch.einsum("nai,naj,n->ij", J, J, W))
        b = Q(torch.einsum("nai,na,n->i", J, e, W))
        if lam is None:
            lam, nu = 1e-5 * float(torch.diagonal(H).abs().max()), 2.0
        dx = Q(torch.linalg.solve(H + lam * I6, -b))
        dR, dt = _exp(dx)
        R1, t1 = Q(dR @ R), Q(dR @ t + dt)
        c1, e1, p1, iz1 = cost(R1, t1)
        if bool(torch.isfinite(c1)) and float(c1) < float(c):
            gain = float(c - c1)
            R, t, c, e, p, iz = R1, t1, c1, e1, p1, iz1
            lam, nu = max(lam / 3.0, 1e-15), 2.0
            if gain <= 1e-14 * float(c) or float(dx.abs().max()) < 1e-13:
                break
        else:
            lam, nu = lam * nu, nu * 2.0
            if lam > 1e12:
                break
    g = lambda a: a.to(torch.float64).numpy()
    return g(R), g(t)


def pixels(xw, R, t, K4) -> np.ndarray:
    """(N, 2) projections of world points under the pose, float64."""
    p = np.asarray(xw, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    K = np.asarray(K4, np.float64)
    z = np.where(np.abs(p[:, 2]) < 1e-12, 1e-12, p[:, 2])
    return np.stack([K[0] * p[:, 0] / z + K[2], K[1] * p[:, 1] / z + K[3]], -1)


def pose_px(xw, Ra, ta, Rb, tb, K4) -> float:
    """RMS distance in pixels between the matched points' projections
    under two poses."""
    d = pixels(xw, Ra, ta, K4) - pixels(xw, Rb, tb, K4)
    return float(np.sqrt((d * d).sum(-1).mean()))


def bad_matches(desc_f, desc_m, xw, uv, w, R, t, K4) -> np.ndarray:
    """Per match: True where it cannot be an inlier of the pose (R, t): its
    descriptors lie more than TH_HIGH bits apart, the point lies behind the
    camera, or its weighted squared reprojection error passes the gate."""
    ham = np.unpackbits(np.asarray(desc_f, np.uint8) ^ np.asarray(desc_m, np.uint8),
                        axis=1).sum(1)
    p = np.asarray(xw, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    e = np.asarray(uv, np.float64) - pixels(xw, R, t, K4)
    chi2 = np.asarray(w, np.float64) * (e * e).sum(-1)
    return (ham > TH_HIGH) | (p[:, 2] <= 0) | ~(chi2 <= CHI2)
