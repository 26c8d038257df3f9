"""Small fixed-size linear algebra, closed-form and batched (counterpart of
orbslam_jpminipc_tpu/solvers/linalg3.py): a 6x6 pose system is solved with
two closed-form 3x3 inverses instead of a library factorisation, which is
one short chain of elementwise kernels on the card."""
from __future__ import annotations

import torch


def det3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 determinant (no library call, no host read)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _adjugate3(M: torch.Tensor):
    """(adjugate, determinant) of a batch of 3x3 matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        dim=-2,
    )
    return adj, det


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), the determinant
    kept away from 0."""
    adj, det = _adjugate3(M)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    return adj * inv_det[..., None, None]


def inv3_exact(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det): a singular matrix
    gives infinities or NaN, as an LU inverse does, and nothing waits."""
    adj, det = _adjugate3(M)
    return adj / det[..., None, None]


def solve6_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for symmetric positive-definite 6x6 H (batched) via
    2x2-block Schur elimination with closed-form 3x3 inverses."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    b1 = b[..., :3, None]
    b2 = b[..., 3:, None]
    Ai = inv3(A)
    AiB = Ai @ B
    S = D - B.transpose(-1, -2) @ AiB
    Si = inv3(S)
    rhs2 = b2 - AiB.transpose(-1, -2) @ b1
    x2 = Si @ rhs2
    x1 = Ai @ b1 - AiB @ x2
    return torch.cat([x1, x2], dim=-2)[..., 0]
