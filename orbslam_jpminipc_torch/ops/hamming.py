"""Hamming distance on packed 256-bit ORB descriptors (counterpart of
orbslam_jpminipc_tpu/ops/hamming.py).

PyTorch has no popcount, so the all-pairs matrix uses the reference's
identity for 0/1 bit vectors a, b:
    hamming(a, b) = popcount(a) + popcount(b) - 2 * <a, b>
with <a, b> a float32 matrix product of 0/1 bits (full float32, TF32 off:
every partial sum is an integer <= 256, so it is exact).
"""
from __future__ import annotations

import torch


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 packed -> (N, 256) uint8 in {0, 1}, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256)


def popcount_rows(desc: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N,) int32 number of set bits."""
    return unpack_bits(desc).sum(dim=-1, dtype=torch.int32)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: (..., N, 32), (..., M, 32) uint8 ->
    (..., N, M) int32; leading dimensions broadcast (a batch of targets)."""
    b1 = unpack_bits(d1).to(torch.float32)
    b2 = unpack_bits(d2).to(torch.float32)
    dot = (b1 @ b2.transpose(-1, -2)).to(torch.int32)
    p1 = b1.sum(dim=-1).to(torch.int32)
    p2 = b2.sum(dim=-1).to(torch.int32)
    return p1[..., :, None] + p2[..., None, :] - 2 * dot


def hamming_pairwise(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Element-aligned Hamming distance: (..., 32) x (..., 32) -> (...,) int32
    (the operands broadcast). The set bits of the XOR are counted by
    unpacking them: exact in integers."""
    return popcount_rows(torch.bitwise_xor(d1, d2))
