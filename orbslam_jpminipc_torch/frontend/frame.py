"""Frame: per-image features with lazy device -> host copies (counterpart of
orbslam_jpminipc_tpu/frontend/frame.py).

The features of a frame stay on the device where they were extracted and
are copied to the host (all fields in one transfer) only when host code
first reads one: keyframe insertion, the host tracking path, map building.
A frame that only feeds device programs never pays the copy. The
reference's 64x48 keypoint grid is not kept: matchers mask a dense
distance matrix instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam
from ..ops import extractor
from ..utils.device import resolve_device
from ..utils.host import fetch, upload

_FEAT_FIELDS = ("xy", "xy_un", "level", "angle", "response", "desc", "valid")


class Frame:
    """Padded per-frame features + tracking bookkeeping.

    Feature arrays (xy, xy_un, level, angle, response, desc, valid) read as
    host numpy arrays; `dev` holds the device tensors they come from.
    """

    def __init__(self, frame_id: int, timestamp: float, n_feat: int,
                 host: dict | None = None, dev: dict | None = None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.n_feat = n_feat
        self._host = dict(host) if host else {}
        self._dev = dev
        # pose (world->cam), set by tracking
        self.R: np.ndarray | None = None
        self.t: np.ndarray | None = None
        # map point association per feature (-1 = none), set by tracking
        self.point = np.full(n_feat, -1, np.int32)
        self.point_gen = np.zeros(n_feat, np.int32)
        self.outlier = np.zeros(n_feat, bool)

    def materialize(self):
        """Copy every device-resident feature field to the host (one
        transfer). No-op when already host-resident."""
        if self._dev is not None:
            missing = [f for f in _FEAT_FIELDS if f not in self._host]
            if missing:
                for f, v in zip(missing, fetch(*[self._dev[f] for f in missing])):
                    self._host[f] = v
        return self

    def feature_tensor(self, name: str, device) -> torch.Tensor:
        """A feature field as a tensor on `device`: the resident one when the
        frame was extracted there (no copy), else an upload of the host copy."""
        if self._dev is not None and name in self._dev and self._dev[name].device == torch.device(device):
            return self._dev[name]
        return upload(self._get(name), device)

    def _get(self, name: str) -> np.ndarray:
        if name not in self._host:
            if self._dev is None:
                raise AttributeError(name)
            self.materialize()
        return self._host[name]

    @property
    def xy(self) -> np.ndarray:        # (N, 2) raw keypoints (level-0 scale)
        return self._get("xy")

    @property
    def xy_un(self) -> np.ndarray:     # (N, 2) undistorted positions
        return self._get("xy_un")

    @property
    def level(self) -> np.ndarray:     # (N,) int32
        return self._get("level")

    @property
    def angle(self) -> np.ndarray:     # (N,) float32
        return self._get("angle")

    @property
    def response(self) -> np.ndarray:  # (N,)
        return self._get("response")

    @property
    def desc(self) -> np.ndarray:      # (N, 32) uint8
        return self._get("desc")

    @property
    def valid(self) -> np.ndarray:     # (N,) bool
        return self._get("valid")

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


def build_frame(image, cfg: SlamConfig, frame_id: int = 0, timestamp: float = 0.0,
                n_features: int | None = None, device=None) -> Frame:
    """Extract features and undistort keypoints (Frame.cc:56-123). `image`
    is a (H, W) uint8 host array or tensor; the extraction runs on
    `device` (on the card, FAST is the CUDA kernel)."""
    img = upload(image, resolve_device(device))
    feats = extractor.extract(
        img.to(torch.float32),
        n_features=n_features or cfg.n_features,
        n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor,
        fast_th=cfg.fast_threshold,
        fast_min_th=cfg.fast_min_threshold,
        use_harris_score=cfg.use_harris_score,
    )
    if np.any(cfg.dist4 != 0):
        xy_un = cam.undistort_points(
            feats.xy, upload(cfg.K4, img.device), upload(cfg.dist4, img.device), iters=8)
    else:
        xy_un = feats.xy
    dev = {
        "xy": feats.xy, "xy_un": xy_un, "level": feats.level,
        "angle": feats.angle, "response": feats.response,
        "desc": feats.desc, "valid": feats.valid,
    }
    return Frame(frame_id=frame_id, timestamp=timestamp,
                 n_feat=int(feats.valid.shape[0]), dev=dev)


def predict_scale_level(dist: np.ndarray, max_dist: np.ndarray, scale_factor: float,
                        n_levels: int) -> np.ndarray:
    """Pyramid-level prediction from distance within the scale band
    (MapPoint::PredictScale usage in Frame::isInFrustum, Frame.cc:137-198)."""
    ratio = np.maximum(max_dist, 1e-9) / np.maximum(dist, 1e-9)
    level = np.ceil(np.log(np.maximum(ratio, 1e-9)) / np.log(scale_factor))
    return np.clip(level, 0, n_levels - 1).astype(np.int32)
