"""Trajectory output (TUM format) and ATE evaluation (counterpart of
orbslam_jpminipc_tpu/io/trajectory.py).

The keyframe trajectory dump (`timestamp tx ty tz qx qy qz qw`, the
camera-to-world pose) and the ATE-RMSE after a least-squares similarity
(Umeyama) alignment, scale included for monocular runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3


def save_tum(path: str, trajectory: list[tuple[float, np.ndarray, np.ndarray]]):
    """trajectory entries are (timestamp, R_cw, t_cw); the file stores the
    camera-to-world transform."""
    with open(path, "w") as f:
        for ts, R, t in trajectory:
            R_wc = R.T
            t_wc = -R.T @ t
            q = se3.quat_from_mat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
            f.write(
                f"{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def camera_centers(trajectory) -> np.ndarray:
    """(N, 3) camera centers from (ts, R_cw, t_cw) entries."""
    return np.stack([-R.T @ t for _, R, t in trajectory])


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst: returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = est_centers @ (s * R).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=1))))
