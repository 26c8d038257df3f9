"""Trajectory error against the renderer's ground truth, NumPy only.

Monocular SLAM fixes its own frame and scale (the first keyframe at the
origin, the initial map's median depth 1), so estimated camera centres are
compared with the true ones after the similarity transform that fits them
best (Umeyama, 1991), one fit per stretch of one map."""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) minimising sum |dst - (s R src + t)|^2 over (N, 3) sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    cov = b.T @ a / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (a * a).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def aligned_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-frame distance between the aligned estimate and the truth."""
    s, R, t = umeyama(est, gt)
    return np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
