"""Frame: per-image features with lazy device -> host copies (counterpart of
orbslam_jpminipc_tpu/frontend/frame.py).

The features of a frame stay on the device where they were extracted and
are copied to the host (all fields in one transfer) only when host code
first reads one: keyframe insertion, the host tracking path, map building.
A frame that only feeds device programs never pays the copy. The
reference's 64x48 keypoint grid is not kept: matchers mask a dense
distance matrix instead.

`Extraction` runs `build_frame`'s extraction as captured programs, cut where
`extractor.extract` reads the host, as the WORKING step is cut
(fused_track.py); `Slam` extracts every host-path frame through it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam
from ..ops import extractor
from ..utils import program
from ..utils.device import resolve_device
from ..utils.host import fetch, upload
from ..utils.program import GraphPool, Program

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


class Extraction:
    """`build_frame`'s extraction as captured programs (utils/program.py),
    one set per feature budget (the reference compiles its extractor per
    static budget: `n_features` for fused-size and relocalization frames,
    twice that for initialization frames). A frame is `detect` (the image
    copied in, pyramid, the FAST launch, every level's cell candidates),
    one host read of every level's fast-path flag, one `pick` per level in
    the variant its flag names (each writes the level's selection into
    fixed buffers, so either variant feeds the same `describe`), and
    `describe` (descriptors and undistorted keypoints, copied out: a frame
    keeps its features across later frames). On the CPU the programs run
    eagerly."""

    def __init__(self, cfg: SlamConfig, device=None, pool: GraphPool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = pool if pool is not None else GraphPool()
        self.has_dist = bool(np.any(cfg.dist4 != 0))
        self.K4 = upload(cfg.K4, self.device)
        self.dist4 = upload(cfg.dist4, self.device)
        self._budgets: dict = {}   # n_features -> (detect, picks, describe)
        self.last_fast_ok = None   # the last frame's host read

    def _detect(self, n: int, _variant, image_u8):
        cfg = self.cfg
        return extractor.detect(
            image_u8.to(torch.float32), n_features=n, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, fast_th=cfg.fast_threshold,
            fast_min_th=cfg.fast_min_threshold)

    @staticmethod
    def _pick_into(out, quota: int, fast_ok: bool, score, cand):
        idx, valid = extractor.pick(score, quota, cand, fast_ok)
        out[0].copy_(idx)
        out[1].copy_(valid)

    def _describe(self, n: int, picks, _variant, det):
        cfg = self.cfg
        feats = extractor.describe(det, picks, n_features=n, n_levels=cfg.n_levels,
                                   scale_factor=cfg.scale_factor,
                                   use_harris_score=cfg.use_harris_score)
        xy_un = (cam.undistort_points(feats.xy, self.K4, self.dist4, iters=8)
                 if self.has_dist else feats.xy)
        return feats, xy_un

    def programs(self, n: int) -> tuple:
        """(detect, [pick per level], describe) at budget `n`."""
        progs = self._budgets.get(n)
        if progs is None:
            cfg, dev, pool = self.cfg, self.device, self.pool
            plan = extractor.level_plan(n, cfg.n_levels, cfg.scale_factor)
            picks = [(torch.zeros(q, dtype=torch.int64, device=dev),
                      torch.zeros(q, dtype=torch.bool, device=dev)) for _, q in plan]
            progs = self._budgets[n] = (
                Program(functools.partial(self._detect, n), dev, f"extract_detect[{n}]",
                        copy_in=True, pool=pool),
                [Program(functools.partial(self._pick_into, out, q), dev,
                         f"extract_pick{k}[{n}]", pool=pool)
                 for k, (out, (_, q)) in enumerate(zip(picks, plan))],
                Program(functools.partial(self._describe, n, picks), dev,
                        f"extract_describe[{n}]", copy_out=True, pool=pool),
            )
        return progs

    @torch.no_grad()
    def run(self, image, n: int):
        """(Features, xy_un) of a (H, W) uint8 frame (host array or
        tensor) at budget `n`, copies."""
        detect, picks, describe = self.programs(n)
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(image))
        det = detect.run(None, img)
        # the one host read: every level's fast-path flag, in one transfer
        self.last_fast_ok = det.fast_ok.tolist()
        for prog, ok, score, cand in zip(picks, self.last_fast_ok, det.scores, det.cands):
            prog.run(ok, score, cand)
        out = describe.run(None, det)
        if program._log is not None:
            program._log.note(f"extract[{n}]", None, (img,), out,
                              lambda im: extract_eager(im, self.cfg, n), self.device)
        return out

    @torch.no_grad()
    def capture(self, budgets):
        """Capture every program at each budget ahead of the first frame:
        both variants of every pick, on a blank frame. On the CPU nothing
        is captured."""
        cfg = self.cfg
        for n in budgets:
            detect, picks, describe = self.programs(n)
            det = detect.run(None, torch.zeros((cfg.height, cfg.width), dtype=torch.uint8))
            for ok in (False, True):
                for prog, score, cand in zip(picks, det.scores, det.cands):
                    prog.run(ok, score, cand)
            describe.capture(None, det)

    @property
    def all_programs(self) -> list:
        return [p for d, picks, e in self._budgets.values() for p in (d, *picks, e)]


def extract_eager(image, cfg: SlamConfig, n: int):
    """(Features, xy_un) of a (H, W) uint8 frame, extracted eagerly on the
    image's device: `extractor.extract`, then the undistortion."""
    feats = extractor.extract(
        image.to(torch.float32), n_features=n, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor, fast_th=cfg.fast_threshold,
        fast_min_th=cfg.fast_min_threshold, use_harris_score=cfg.use_harris_score)
    if not np.any(cfg.dist4 != 0):
        return feats, feats.xy
    dev = image.device
    return feats, cam.undistort_points(feats.xy, upload(cfg.K4, dev), upload(cfg.dist4, dev),
                                       iters=8)


def build_frame(image, cfg: SlamConfig, frame_id: int = 0, timestamp: float = 0.0,
                n_features: int | None = None, device=None,
                extraction: Extraction | None = None) -> Frame:
    """Extract features and undistort keypoints (Frame.cc:56-123). `image`
    is a (H, W) uint8 host array or tensor; the extraction runs on
    `device` (on the card, FAST is the CUDA kernel), through the captured
    programs of `extraction` when given (which then names the device)."""
    n = n_features or cfg.n_features
    if extraction is not None:
        feats, xy_un = extraction.run(image, n)
    else:
        feats, xy_un = extract_eager(upload(image, resolve_device(device)), cfg, n)
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
