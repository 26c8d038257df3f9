"""Where the port's entry points run: `device=None` is the current CUDA
device and raises without one; the CPU is used only when it is named."""
import dataclasses

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.frame import build_frame
from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
from orbslam_jpminipc_torch.frontend.tracking import Tracker
from orbslam_jpminipc_torch.map.device_map import DeviceMap, map_from_snapshot
from orbslam_jpminipc_torch.map.map_state import MapState
from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils.device import resolve_device

torch.set_num_threads(2)

CFG = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=200, max_kf=8,
                 max_mp=256, pipelined_tracking=False, async_mapping=False)


def _image():
    return np.random.default_rng(0).integers(0, 256, (96, 128)).astype(np.uint8)


def _state():
    return MapState.create(8, 256, 64, 8, device="cpu")


# name -> (call with a device keyword, where the result keeps its device)
ENTRY_POINTS = {
    "Slam": (lambda **k: Slam(CFG, **k), lambda r: r.device),
    "FusedContext": (lambda **k: FusedContext(CFG, n_map=64, **k), lambda r: r.device),
    "build_frame": (lambda **k: build_frame(_image(), CFG, n_features=50, **k),
                    lambda r: r._dev["xy"].device),
    "Tracker": (lambda **k: Tracker(CFG, _state(), **k), lambda r: r.device),
    "LocalMapper": (lambda **k: LocalMapper(CFG, _state(), **k), lambda r: r.dmap.device),
    "DeviceMap": (lambda **k: DeviceMap(8, 64, 256, **k), lambda r: r.device),
    "map_from_snapshot": (lambda **k: map_from_snapshot(dataclasses.asdict(_state()), **k),
                          lambda r: r[1].device),
    "MapState.create": (lambda **k: MapState.create(8, 256, 64, 8, **k), lambda r: r.device),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_none_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, _ = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="device"):
        call()
    with pytest.raises(RuntimeError, match="device"):
        call(device=None)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_cpu_runs_on_the_cpu(name):
    call, device_of = ENTRY_POINTS[name]
    assert device_of(call(device="cpu")) == torch.device("cpu")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.gpu
def test_device_none_is_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    assert resolve_device(None) == dev and resolve_device("cuda") == dev
    for name, (call, device_of) in ENTRY_POINTS.items():
        assert device_of(call()) == dev, name
