"""Configuration, mirroring the reference's settings surface.

The same dataclass as orbslam_jpminipc_tpu/config.py (numpy only), so a
configuration means the same thing in both packages. `from_yaml` reads the
reference's OpenCV YAML settings layout without cv2.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlamConfig:
    # Camera.* (Tracking.cc:52-70)
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    fps: float = 30.0
    rgb: bool = True

    # image geometry (static shapes for the jitted extractor)
    width: int = 640
    height: int = 480

    # ORBextractor.* (Tracking.cc:102-129, include/ORBextractor.h:38)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    use_harris_score: bool = False

    # Tracking behavior
    use_motion_model: bool = True

    # Fused device-resident WORKING path (frontend/fused_track.py): the
    # whole per-frame steady-state step runs over a device-resident
    # local-map slice as captured programs (one graph launch when
    # pipelined) — one image upload + one read per frame. The host path
    # remains for init/reloc/fallback.
    fused_tracking: bool = True

    # Pipelined tracking: dispatch frame N's fused step without waiting for
    # the device and run the host bookkeeping of frame N-k (k <= pipeline_depth)
    # once its results have landed, so the host's work overlaps the device's;
    # keyframe decisions lag by the pipeline depth, the reference's
    # mapper-thread lag (LocalMapping::Run polls at 5 Hz,
    # LocalMapping.cc:52-127). Turn off for frame-synchronous semantics
    # (tests, lowest-latency pose out).
    pipelined_tracking: bool = True
    # in-flight budget: frames dispatched and not yet completed; keyframe
    # decisions lag by at most this many frames (~0.2 s at 30 fps)
    pipeline_depth: int = 6
    # adaptive guard: while the last completed frame's inlier count is
    # below this, drain to depth 1 (near-synchronous) so keyframe
    # decisions land immediately — deep pipelining delays KF insertion by
    # `depth` frames, which in rotation-heavy stretches starves the map
    # right when it must grow fastest
    pipeline_guard_inliers: int = 80

    # Mapping overlap: when True, the per-keyframe mapping stages
    # (triangulate / fuse / local BA / cull / loop detection) run one per
    # subsequent frame instead of synchronously at KF insertion — the
    # deterministic equivalent of the reference's mapper+loop threads
    # overlapping the tracker (main.cc:165-218). A new KF cancels a
    # not-yet-run queued local BA (InterruptBA, LocalMapping.cc:130-136).
    # Default ON: besides hiding the mapping spike, the busy mapper throttles
    # keyframe insertion exactly like the reference's AcceptKeyFrames gate
    # (Tracking.cc:684) — without it every frame passes c1b and the map
    # floods with tiny-baseline keyframes.
    async_mapping: bool = True

    # capacities (padded array sizes; power-of-two friendly)
    max_kf: int = 256
    max_mp: int = 16384
    max_obs: int = 32
    local_ba_kf: int = 24      # local-KF budget for local BA
    local_ba_fixed: int = 24   # fixed-KF budget
    local_ba_points: int = 2048  # point capacity (ONE static shape -> one
                                 # XLA program for every local BA call; a
                                 # local map rarely holds more live points —
                                 # overflow keeps the best-anchored ones)
    local_ba_obs: int = 8192   # observation budget for local BA

    # essential-graph edge capacity (static shape for the pose-graph LM)
    eg_edges: int = 2048

    # global BA over the whole map (scalable implicit-Schur solver)
    post_loop_gba: bool = False   # run global BA after each loop closure
    # route global BA / essential graph to the map-partitioned multi-device
    # solvers (parallel/) whenever more than one device is visible
    distributed_gba: bool = True
    gba_iterations: int = 20      # LM budget (Optimizer.cc:38 default 5/20)
    gba_cg_iters: int = 64        # PCG budget for the reduced camera system
    gba_obs: int = 65536          # observation capacity of the global problem

    # vocabulary
    n_words: int = 4096

    seed: int = 0

    @property
    def K4(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)

    @property
    def dist4(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2], np.float32)

    @property
    def max_frames(self) -> int:
        # keyframe-insertion window: 18 * fps / 30 (Tracking.cc:78)
        return int(18 * (self.fps if self.fps > 0 else 30) / 30)

    @property
    def scale_factors(self) -> np.ndarray:
        return np.array(
            [self.scale_factor ** i for i in range(self.n_levels)], np.float32
        )

    @property
    def sigma2(self) -> np.ndarray:
        return self.scale_factors ** 2

    @property
    def inv_sigma2(self) -> np.ndarray:
        return 1.0 / self.sigma2

    @staticmethod
    def from_yaml(path: str) -> "SlamConfig":
        """Load the reference's settings.yaml layout (cv::FileStorage keys
        Camera.fx etc., Tracking.cc:52-129): flat `Key.name: number` lines
        under a `%YAML:1.0` header. Read without cv2, so it works where cv2
        is not installed; other node types are skipped."""
        vals = {}
        with open(path) as f:
            for line in f:
                key, sep, value = line.split("#", 1)[0].partition(":")
                if not sep or key.startswith("%"):
                    continue
                try:
                    vals[key.strip()] = float(value.strip().strip('"'))
                except ValueError:
                    continue
        g = vals.get
        return SlamConfig(
            fx=g("Camera.fx", 517.3), fy=g("Camera.fy", 516.5),
            cx=g("Camera.cx", 318.6), cy=g("Camera.cy", 255.3),
            k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0),
            p1=g("Camera.p1", 0.0), p2=g("Camera.p2", 0.0),
            fps=g("Camera.fps", 30.0) or 30.0,
            rgb=bool(int(g("Camera.RGB", 1))),
            n_features=int(g("ORBextractor.nFeatures", 1000)),
            scale_factor=g("ORBextractor.scaleFactor", 1.2),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            fast_threshold=g("ORBextractor.fastTh", 20.0) or 20.0,
            use_harris_score=int(g("ORBextractor.nScoreType", 1)) == 0,
            use_motion_model=bool(int(g("UseMotionModel", 1))),
        )
