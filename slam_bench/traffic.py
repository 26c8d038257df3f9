"""The one traffic generator: a camera stream made from a traffic mix's
parameters (a JSON file under `traffic/`) and a configuration's camera.

A mix names a trajectory of the rendered room and its period in frames, and
may add covered-lens episodes. Every frame is made in set-up from `--seed`:
one period of clean frames rendered on the device and copied to the host,
and a bank of dark frames. The window then hands frame i to the system as a
host uint8 array, as a camera driver delivers it, with the timestamp
i / fps of the configuration's camera clock.

Keys of a mix file:
  trajectory   `xyz`, `loop` or `orbit` (scene.trajectory_poses)
  period       frames a trajectory takes before it repeats
  occlusion    optional: {"first": frame of the first episode, "every":
               frames from one episode's start to the next, "frames": dark
               frames an episode lasts, "mean_dn", "sigma_dn": the dark
               image's grey level and noise, "bank": dark images drawn}
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .scene import SyntheticSequence

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


@dataclass(frozen=True)
class Occlusion:
    first: int
    every: int
    frames: int
    mean_dn: float
    sigma_dn: float
    bank: int = 8

    def covered(self, i: int) -> bool:
        return i >= self.first and (i - self.first) % self.every < self.frames


class Stream:
    """A mix's frames for one seed. `frame(i)` -> (image, timestamp, clean):
    the host uint8 (H, W) image of frame i, its timestamp, and whether the
    lens is clear. `center(i)` is the camera's true centre (world). With
    `frames`, only the first `frames` frames can be asked for."""

    def __init__(self, mix: dict, camera: dict, seed: int, device, frames: int | None = None):
        self.period = int(mix["period"])
        self.fps = float(camera["fps"])
        K4 = (camera["fx"], camera["fy"], camera["cx"], camera["cy"])
        t0 = time.monotonic()
        seq = SyntheticSequence(self.period, int(camera["width"]), int(camera["height"]), K4,
                                mix["trajectory"], seed, device)
        self.scene_s = time.monotonic() - t0
        with torch.no_grad():
            # a run that feeds fewer frames than a period renders only those
            n = min(self.period, frames or self.period)
            self.images = np.stack([seq.render(i).cpu().numpy() for i in range(n)])
        self.render_s = time.monotonic() - t0 - self.scene_s
        self.centers = np.stack([-R.T.astype(np.float64) @ t for R, t in seq.poses])
        occ = mix.get("occlusion")
        self.occlusion = Occlusion(**occ) if occ else None
        self.dark = None
        if self.occlusion is not None:
            o = self.occlusion
            rng = np.random.default_rng([seed, 0x0CC1])
            shape = (o.bank,) + self.images.shape[1:]
            self.dark = np.clip(np.rint(rng.normal(o.mean_dn, o.sigma_dn, shape)),
                                0, 255).astype(np.uint8)

    def clean(self, i: int) -> bool:
        return self.occlusion is None or not self.occlusion.covered(i)

    def frame(self, i: int):
        if self.clean(i):
            img = self.images[i % self.period]
        else:
            img = self.dark[i % len(self.dark)]
        return img, i / self.fps, self.clean(i)

    def center(self, i: int) -> np.ndarray:
        return self.centers[i % self.period]
