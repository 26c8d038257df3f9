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
from orbslam_jpminipc_torch.io.checkpoint import load_world, save_world
from orbslam_jpminipc_torch.io.dataset import SyntheticSequence, TumDataset
from orbslam_jpminipc_torch.geometry import sim3
from orbslam_jpminipc_torch.map.device_map import DeviceMap, map_from_snapshot
from orbslam_jpminipc_torch.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc_torch.map.map_state import MapState
from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper
from orbslam_jpminipc_torch.pipeline.loop_closing import LoopCloser
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils.device import resolve_device
from orbslam_jpminipc_torch.vocab.tree import TreeVocabulary, load_dbow2_tree
from orbslam_jpminipc_torch.vocab.vocabulary import (
    Vocabulary, load_dbow2_text, load_vocabulary, save_vocabulary, vocab_from_numpy)

torch.set_num_threads(2)

CFG = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=200, max_kf=8,
                 max_mp=256, pipelined_tracking=False, async_mapping=False)


def _image():
    return np.random.default_rng(0).integers(0, 256, (96, 128)).astype(np.uint8)


def _state():
    return MapState.create(8, 256, 64, 8, device="cpu")


def _flat_arrays():
    """A flat vocabulary as host arrays (what `vocab_from_numpy` takes)."""
    rng = np.random.default_rng(1)
    return Vocabulary(words=rng.integers(0, 256, (16, 32)).astype(np.uint8),
                      idf=np.ones(16, np.float32))


def _tree_arrays():
    """A two-level tree as host arrays: a root with three leaves."""
    rng = np.random.default_rng(2)
    return TreeVocabulary(
        child_idx=np.array([[1, 2, 3], [-1] * 3, [-1] * 3, [-1] * 3], np.int32),
        node_desc=rng.integers(0, 256, (4, 32)).astype(np.uint8),
        node_word=np.array([-1, 0, 1, 2], np.int32),
        word_weight=np.ones(3, np.float32), depth=1)


def _vocab_file(tmp, arrays):
    path = str(tmp / "vocab.npz")
    save_vocabulary(vocab_from_numpy(arrays, device="cpu"), path)
    return path


def _dbow2_text(tmp):
    path = str(tmp / "voc.txt")
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        f.write("3 1 0 0\n")
        for _ in range(3):
            f.write("0 1 " + " ".join(str(b) for b in rng.integers(0, 256, 32)) + " 1.5\n")
    return path


# name -> (call with a device keyword, where the result keeps its device)
ENTRY_POINTS = {
    "Slam": (lambda **k: Slam(CFG, **k), lambda r: r.device),
    # the default constructor call with a vocabulary: loop closing on
    "Slam[vocabulary]": (lambda **k: Slam(CFG, vocab=vocab_from_numpy(_flat_arrays(), **k),
                                          **k), lambda r: r.loop_closer.device),
    "LoopCloser": (lambda **k: LoopCloser(CFG, _state(), None, **k), lambda r: r.device),
    "sim3.identity": (lambda **k: sim3.identity(**k), lambda r: r[1].device),
    "FusedContext": (lambda **k: FusedContext(CFG, n_map=64, **k), lambda r: r.device),
    "build_frame": (lambda **k: build_frame(_image(), CFG, n_features=50, **k),
                    lambda r: r._dev["xy"].device),
    "Tracker": (lambda **k: Tracker(CFG, _state(), **k), lambda r: r.device),
    "LocalMapper": (lambda **k: LocalMapper(CFG, _state(), **k), lambda r: r.dmap.device),
    "DeviceMap": (lambda **k: DeviceMap(8, 64, 256, **k), lambda r: r.device),
    "map_from_snapshot": (lambda **k: map_from_snapshot(dataclasses.asdict(_state()), **k),
                          lambda r: r[1].device),
    "MapState.create": (lambda **k: MapState.create(8, 256, 64, 8, **k), lambda r: r.device),
    "vocab_from_numpy[flat]": (lambda **k: vocab_from_numpy(_flat_arrays(), **k),
                               lambda r: r.words.device),
    "vocab_from_numpy[tree]": (lambda **k: vocab_from_numpy(_tree_arrays(), **k),
                               lambda r: r.node_desc.device),
    # the renderer draws on its device
    "SyntheticSequence": (lambda **k: SyntheticSequence(n_frames=2, trajectory="forward", **k),
                          lambda r: r.render(1).device),
}


@pytest.fixture
def file_entry_points(tmp_path):
    """The entry points that read a file, and the database (whose
    vocabulary must lie on the database's device)."""
    flat, tree, text = (_vocab_file(tmp_path, _flat_arrays()),
                        None, _dbow2_text(tmp_path))
    tree = str(tmp_path / "tree.npz")
    save_vocabulary(vocab_from_numpy(_tree_arrays(), device="cpu"), tree)
    cpu_vocab = vocab_from_numpy(_flat_arrays(), device="cpu")
    (tmp_path / "rgb.txt").write_text("0.0 a.png\n")
    world = str(tmp_path / "w.npz")
    save_world(world, _state())
    return {
        "TumDataset": (lambda **k: TumDataset(str(tmp_path), **k), lambda r: r.device),
        "load_world": (lambda **k: load_world(world, **k), lambda r: r.device),
        "load_vocabulary[flat]": (lambda **k: load_vocabulary(flat, **k), lambda r: r.device),
        "load_vocabulary[tree]": (lambda **k: load_vocabulary(tree, **k), lambda r: r.device),
        "load_dbow2_text": (lambda **k: load_dbow2_text(text, **k), lambda r: r.device),
        "load_dbow2_tree": (lambda **k: load_dbow2_tree(text, **k), lambda r: r.device),
        "KeyFrameDatabase": (lambda **k: KeyFrameDatabase(cpu_vocab, 8, **k), lambda r: r.device),
    }


FILE_ENTRY_POINTS = ("TumDataset", "load_world", "load_vocabulary[flat]",
                     "load_vocabulary[tree]", "load_dbow2_text", "load_dbow2_tree",
                     "KeyFrameDatabase")


@pytest.mark.parametrize("name", FILE_ENTRY_POINTS)
def test_vocabulary_entry_points_raise_without_a_card(monkeypatch, file_entry_points, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, _ = file_entry_points[name]
    with pytest.raises(RuntimeError, match="device"):
        call()
    with pytest.raises(RuntimeError, match="device"):
        call(device=None)


@pytest.mark.parametrize("name", FILE_ENTRY_POINTS)
def test_vocabulary_entry_points_run_on_the_cpu_when_named(file_entry_points, name):
    call, device_of = file_entry_points[name]
    assert device_of(call(device="cpu")) == torch.device("cpu")


def test_database_refuses_a_vocabulary_on_another_device():
    """The descent runs on the database's device: a vocabulary elsewhere is
    an error, not a silent copy per call."""
    class Elsewhere(Vocabulary):
        @property
        def device(self):
            return torch.device("meta")

    v = vocab_from_numpy(_flat_arrays(), device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        KeyFrameDatabase(Elsewhere(*v), 8, device="cpu")


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


@pytest.mark.gpu
def test_vocabulary_entry_points_default_to_the_card(file_entry_points):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    for name in FILE_ENTRY_POINTS[:-1]:
        call, device_of = file_entry_points[name]
        assert device_of(call()) == dev, name
    db = KeyFrameDatabase(vocab_from_numpy(_flat_arrays()), 8)
    assert db.device == dev
    desc = np.random.default_rng(4).integers(0, 256, (40, 32)).astype(np.uint8)
    db.add(2, desc, np.ones(40, bool))
    cpu = KeyFrameDatabase(vocab_from_numpy(_flat_arrays(), device="cpu"), 8, device="cpu")
    cpu.add(2, desc, np.ones(40, bool))
    np.testing.assert_array_equal(db.bow_ids, cpu.bow_ids)  # the card's word ids are the CPU's


@pytest.mark.gpu
def test_fetch_async_on_the_card_lands_without_a_wait_and_equals_fetch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from orbslam_jpminipc_torch.utils import host

    gen = torch.Generator(device="cuda").manual_seed(0)
    tensors = (torch.rand((300, 7), generator=gen, device="cuda"),
               torch.arange(11, dtype=torch.int32, device="cuda"),
               torch.rand(5, generator=gen, device="cuda") > 0.5)
    ref = host.fetch(*tensors)
    reads = host.get_tracer().counts["reads"]
    # queue the read behind a long program: it cannot have landed at once
    a = torch.rand((4096, 4096), generator=gen, device="cuda")
    for _ in range(20):
        a = a @ a * 1e-3
    h = host.fetch_async(*tensors)
    assert host.get_tracer().counts["reads"] == reads + 1
    early = h.done()
    deadline = time.perf_counter() + 30.0
    while not h.done() and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert h.done() and not early
    for g, r in zip(h.result(), ref):
        np.testing.assert_array_equal(g, r)
