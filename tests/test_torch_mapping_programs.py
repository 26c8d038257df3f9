"""The map mirror's stage programs (map/device_map.py), port only unless
said.

Every sync writes into the mirror's tensors and never rebinds one, because
the stage programs read them in place (a captured graph reads the addresses
of its capture): held here by each tensor's `data_ptr()` across every sync
and `clear`, and by the mirror's contents against the host map after each.
The point scatter runs at each of its first two row buckets. Each stage's
entry point runs its program (one per input shape; outputs copied out, so a
later call leaves an earlier call's outputs as they were), and the attrs
pass at a bucket above 256 is held to the JAX package's (the CPU parity of
every other stage is tests/test_torch_mapping.py's, through the same entry
points). `release` drops the programs and keeps the mirror; a dropped mirror, or
a dropped system, is freed without the collector (no reference cycle
holds its programs). The `gpu`-marked tests replay the captured programs
after `sync_all`, `sync_points` and `sync_poses` and hold them to the
stage functions run eagerly on the same mirror, equal bits, and give a
dropped mirror's graph pool back at once. This file imports
jax only inside its CPU parity test, so the card's machine (no jax) runs
its `gpu` test.
"""
import types

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.map import device_map as tdmap
from orbslam_jpminipc_torch.map.device_map import MIRRORED, DeviceMap

torch.set_num_threads(2)

MAX_KF, N_FEAT, MAX_MP, MAX_OBS = 6, 64, 600, 4
K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
SF = (1.2 ** np.arange(8)).astype(np.float32)
SIGMA2 = SF ** 2


def _random_map(seed):
    """The mirrored arrays of a host map, random: poses from random
    rotations, some depth bands infinite (the mirror keeps 0 there)."""
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(MAX_KF, 3, 3)))[0]
    R *= np.sign(np.linalg.det(R))[:, None, None]
    maxd = rng.uniform(1, 8, MAX_MP).astype(np.float32)
    maxd[rng.uniform(size=MAX_MP) < 0.1] = np.inf
    return types.SimpleNamespace(
        kf_desc=rng.integers(0, 256, (MAX_KF, N_FEAT, 32), dtype=np.uint8),
        kf_xy=rng.uniform([0, 0], [640, 480], (MAX_KF, N_FEAT, 2)).astype(np.float32),
        kf_angle=rng.uniform(0, 360, (MAX_KF, N_FEAT)).astype(np.float32),
        kf_level=rng.integers(0, 8, (MAX_KF, N_FEAT)).astype(np.int32),
        kf_feat_valid=rng.uniform(size=(MAX_KF, N_FEAT)) < 0.9,
        kf_R=R.astype(np.float32), kf_t=rng.normal(0, 0.5, (MAX_KF, 3)).astype(np.float32),
        mp_xyz=(rng.normal(0, 2, (MAX_MP, 3)) + [0, 0, 5]).astype(np.float32),
        mp_desc=rng.integers(0, 256, (MAX_MP, 32), dtype=np.uint8),
        mp_normal=rng.normal(size=(MAX_MP, 3)).astype(np.float32),
        mp_min_dist=rng.uniform(0.1, 1, MAX_MP).astype(np.float32), mp_max_dist=maxd,
        mp_valid=rng.uniform(size=MAX_MP) < 0.8)


def _mirror_of(st) -> dict:
    out = {k: np.asarray(getattr(st, k)) for k in MIRRORED}
    out["mp_max_dist"] = np.where(np.isfinite(out["mp_max_dist"]), out["mp_max_dist"], 0.0)
    return out


def _assert_mirror_equals(dm, st):
    for k, want in _mirror_of(st).items():
        np.testing.assert_array_equal(getattr(dm, k).cpu().numpy(), want, err_msg=k)


def _ptrs(dm) -> dict:
    return {k: t.data_ptr() for k, t in dm.mirror().items()}


def test_every_sync_writes_the_mirror_in_place():
    """`sync_all`, `sync_keyframe`, `sync_poses`, `sync_points` and `clear`
    keep every mirror tensor where it is and leave the mirror equal to the
    host map."""
    st = _random_map(0)
    dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
    ptrs = _ptrs(dm)
    dm.sync_all(st)
    _assert_mirror_equals(dm, st)
    new = _random_map(1)
    for name in ("kf_desc", "kf_xy", "kf_angle", "kf_level", "kf_feat_valid"):
        getattr(st, name)[3] = getattr(new, name)[3]
    st.kf_t[1] += 1.0
    dm.sync_keyframe(st, 3)
    _assert_mirror_equals(dm, st)
    st.kf_R[:] = new.kf_R
    st.kf_t[:] = new.kf_t
    dm.sync_poses(st)
    _assert_mirror_equals(dm, st)
    ids = np.array([5, 7, 7, 599, -1, 600, 42])   # repeats and ids off the map are dropped
    rows = np.array([5, 7, 599, 42])
    for name in ("mp_xyz", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_valid"):
        getattr(st, name)[rows] = getattr(new, name)[rows]
    dm.sync_points(st, ids)
    _assert_mirror_equals(dm, st)
    dm.sync_all(new)
    _assert_mirror_equals(dm, new)
    assert _ptrs(dm) == ptrs
    dm.clear()
    assert _ptrs(dm) == ptrs and dm.version == 0
    empty = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
    for k, t in empty.mirror().items():
        assert torch.equal(getattr(dm, k), t), k


def test_sync_all_of_a_map_of_other_capacities_makes_a_mirror_of_its_own():
    """A map of other capacities (a Slam given another map, as the tests of
    the loop scene do): new tensors at its sizes, equal to it, and new
    programs, none captured on the old tensors."""
    dm = DeviceMap(MAX_KF + 2, N_FEAT, MAX_MP, device="cpu")
    old = dm.programs
    st = _random_map(12)
    dm.sync_all(st)
    assert (dm.max_kf, dm.n_feat, dm.max_mp) == (MAX_KF, N_FEAT, MAX_MP)
    assert dm.programs is not old and not any(s.programs for s in dm.programs.values())
    _assert_mirror_equals(dm, st)


def test_release_drops_the_programs_and_keeps_the_mirror():
    """`release` gives the mirror new programs, none made yet, on a new
    pool; the mirror's tensors and values stay, and a stage run afterwards
    equals its run before."""
    st = _random_map(13)
    dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
    dm.sync_all(st)
    args = _stage_args(st, np.random.default_rng(14))["fuse"]
    before = _leaves(tdmap.fuse_kernel(dm, *args))
    old, ptrs = dm.programs, _ptrs(dm)
    dm.release()
    assert not any(s.programs for s in dm.programs.values())
    assert dm.programs["fuse"].pool is not old["fuse"].pool
    assert _ptrs(dm) == ptrs
    _assert_mirror_equals(dm, st)
    for a, b in zip(_leaves(tdmap.fuse_kernel(dm, *args)), before):
        assert torch.equal(a, b)


def test_a_dropped_mirror_or_system_is_freed_without_the_collector():
    """With the collector off, dropping the last reference to a mirror
    whose programs have run, or to a whole system, frees the mirror at
    once: nothing of it is held in a reference cycle (on a card its
    programs' graph pool goes with it)."""
    import gc
    import weakref

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.system import Slam

    st = _random_map(15)
    gc_on = gc.isenabled()
    gc.disable()
    try:
        dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
        dm.sync_all(st)
        for stage, args in _stage_args(st, np.random.default_rng(16)).items():
            ENTRY[stage](dm, *args)
        dm.sync_points(st, np.arange(40))
        dropped = weakref.ref(dm)
        del dm
        assert dropped() is None
        slam = Slam(SlamConfig(n_features=300, max_kf=16, max_mp=2048), vocab=None,
                    device="cpu")
        dropped = weakref.ref(slam.mapper.dmap), weakref.ref(slam)
        del slam
        assert [r() for r in dropped] == [None, None]
    finally:
        if gc_on:
            gc.enable()


@pytest.mark.parametrize("n, bucket", [(40, 256), (300, 2048)])
def test_sync_points_scatters_at_each_bucket(n, bucket):
    """The touched rows through the scatter program of their bucket (ids
    padded with ids[0]); the other rows stay as they were."""
    st, new = _random_map(2), _random_map(3)
    dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
    dm.sync_all(st)
    ptrs = _ptrs(dm)
    ids = np.sort(np.random.default_rng(n).choice(MAX_MP, n, replace=False))
    for name in ("mp_xyz", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_valid"):
        getattr(st, name)[ids] = getattr(new, name)[ids]
    dm.sync_points(st, ids)
    _assert_mirror_equals(dm, st)
    assert _ptrs(dm) == ptrs
    assert [p.name for p in dm.programs["scatter"].programs.values()] == [
        f"map_scatter[{bucket}]"]


def _stage_args(st, rng):
    """Arguments of each stage's entry point over a map of `st`'s sizes."""
    B, T, M, n = 4, 3, 128, 256
    obs_kf = rng.integers(-1, MAX_KF, (n, MAX_OBS)).astype(np.int32)
    return {
        "tri": (2, np.array([0, 1, 3, 0]), st.kf_feat_valid[2], rng.uniform(size=(B, N_FEAT)) < 0.3,
                np.arange(B)[:, None] < np.full((B, N_FEAT), 3), K4, SIGMA2, SF),
        "fuse": (rng.integers(-1, MAX_MP, (2 * T, N_FEAT)).astype(np.int32),
                 np.ones((2 * T, N_FEAT), bool), np.array([0, 1, 3, 2, 2, 2]), K4, SF),
        "attrs": (obs_kf, rng.integers(0, N_FEAT, (n, MAX_OBS)).astype(np.int32),
                  st.mp_xyz[:n], rng.integers(0, MAX_OBS, n), SF),
        "slice": (rng.integers(0, MAX_MP, M), rng.uniform(size=M) < 0.9,
                  rng.integers(1, 5, M).astype(np.float32)),
    }


ENTRY = {"tri": tdmap.tri_kernel, "fuse": tdmap.fuse_kernel, "attrs": tdmap.attrs_kernel,
         "slice": tdmap.slice_kernel}


def _leaves(out):
    return [x.clone() for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("stage", ["tri", "fuse", "attrs"])
def test_each_stage_runs_as_one_program_per_shape(stage):
    """Two calls of a stage at one shape share its program, and the second
    leaves the first's outputs as they were (they are copies); the outputs
    equal the stage's function run directly on the same inputs."""
    st = _random_map(4)
    dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device="cpu")
    dm.sync_all(st)
    args = _stage_args(st, np.random.default_rng(5))[stage]
    first = ENTRY[stage](dm, *args)
    kept = _leaves(first)
    dm.sync_all(_random_map(6))
    second = ENTRY[stage](dm, *args)
    assert len(dm.programs[stage].programs) == 1
    for a, b in zip(_leaves(first), kept):
        assert torch.equal(a, b)
    with torch.no_grad():
        eager = dm.programs[stage].fn(None, *tdmap._INPUTS[stage](*args))
    for a, b in zip(_leaves(second), _leaves(eager)):
        assert torch.equal(a, b)


def test_attrs_kernel_above_the_first_bucket_matches_jax():
    """The attrs pass at the 2048-row bucket (300 points, their ids and
    observations repeated from the system's map) through each package's
    mirror, written back into the host map: the tolerances of
    tests/test_torch_mapping.py's attrs test."""
    from test_torch_mapping import CFG, _both, _build_world, _check_attrs

    world = _build_world()
    jst, jdm, tst, tdm = _both(world)
    valid = np.nonzero(jst.mp_valid)[0]
    ids = np.resize(valid, 300)   # each point twice or so: the same row written twice
    for st in (jst, tst):
        st.mp_xyz[valid] *= np.float32(1.03)
    jdm.sync_points(jst, valid)
    tdm.sync_points(tst, valid)
    jst.update_point_attributes(ids, CFG.scale_factors, dmap=jdm)
    tst.update_point_attributes(ids, CFG.scale_factors, dmap=tdm)
    assert [p.name for p in tdm.programs["attrs"].programs.values()] == ["map_attrs[2048]"]
    _check_attrs((tst.mp_desc[valid], tst.mp_normal[valid], tst.mp_min_dist[valid],
                  tst.mp_max_dist[valid]),
                 (jst.mp_desc[valid], jst.mp_normal[valid], jst.mp_min_dist[valid],
                  jst.mp_max_dist[valid]))


def test_reset_keeps_the_mirror_and_its_programs():
    """`Slam.reset` empties the mirror in place: the mapper, the tracker and
    the loop closer keep the one mirror, and its programs."""
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.system import Slam

    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=300, max_kf=16,
                     max_mp=2048, local_ba_obs=4096, pipelined_tracking=False)
    slam = Slam(cfg, vocab=None, device="cpu")
    dm = slam.mapper.dmap
    slam._compile_programs()
    names = {k: sorted(p.name for p in s.programs.values()) for k, s in dm.programs.items()}
    assert names["local_ba"] == [f"local_ba[{cfg.local_ba_kf + cfg.local_ba_fixed}x"
                                 f"{cfg.local_ba_points}x{cfg.local_ba_obs}]"]
    assert names["attrs"] == ["map_attrs[2048]", "map_attrs[256]"]
    assert names["scatter"] == ["map_scatter[2048]", "map_scatter[256]"]
    assert all(names[k] for k in ("tri", "fuse", "slice"))
    ptrs = _ptrs(dm)
    slam.reset()
    assert slam.mapper.dmap is dm and slam.tracker.dmap is dm
    assert _ptrs(dm) == ptrs
    assert {k: sorted(p.name for p in s.programs.values())
            for k, s in dm.programs.items()} == names


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_captured_stages_read_the_mirror_after_each_sync(card):
    """Each stage captured on one mirror, then replayed after `sync_all`
    (a new map), `sync_points` and `sync_poses` (new poses): the replay
    equals the stage's function run eagerly on the same mirror (equal
    bits), and the slice holds the new rows."""
    st = _random_map(8)
    dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device=card)
    dm.sync_all(st)
    rng = np.random.default_rng(9)
    args = _stage_args(st, rng)
    for stage in ENTRY:
        dm.capture(stage, None, *args[stage])
    ptrs = _ptrs(dm)

    def check(tag):
        for stage, fn in ENTRY.items():
            got = _leaves(fn(dm, *args[stage]))
            with torch.no_grad():
                eager = _leaves(dm.programs[stage].fn(
                    None, *(x.to(card) for x in tdmap._INPUTS[stage](*args[stage]))))
            for a, b in zip(got, eager):
                assert torch.equal(a, b), (tag, stage)
        ids, valid, _ = args["slice"]
        slc = tdmap.slice_kernel(dm, *args["slice"])
        np.testing.assert_array_equal(slc.xyz.cpu().numpy(), st.mp_xyz[ids])
        np.testing.assert_array_equal(slc.desc.cpu().numpy(), st.mp_desc[ids])

    check("captured")
    st = _random_map(10)
    dm.sync_all(st)
    check("sync_all")
    new = _random_map(11)
    rows = np.unique(args["slice"][0])[:50]
    st.mp_xyz[rows] = new.mp_xyz[rows]
    st.mp_desc[rows] = new.mp_desc[rows]
    dm.capture_scatter(256)
    dm.sync_points(st, rows)
    check("sync_points")
    before = _leaves(tdmap.attrs_kernel(dm, *args["attrs"]))
    st.kf_R[:] = new.kf_R
    st.kf_t[:] = new.kf_t
    dm.sync_poses(st)
    check("sync_poses")
    after = _leaves(tdmap.attrs_kernel(dm, *args["attrs"]))
    assert not torch.equal(before[1], after[1])   # the normals moved with the poses
    assert _ptrs(dm) == ptrs
    for stage in ENTRY:
        assert len(dm.programs[stage].programs) == 1, stage


@pytest.mark.gpu
def test_a_dropped_mirror_returns_its_graph_pool(card):
    """A mirror with every stage captured, dropped: its graphs and their
    pool go at once (no collector pass), so the caching allocator's
    reserved memory falls back to where it was. A first mirror, made and
    dropped the same way, leaves the stages' module caches behind it."""
    import gc

    st = _random_map(17)
    args = _stage_args(st, np.random.default_rng(18))
    gc_on = gc.isenabled()
    gc.disable()
    try:
        held, after = [], []
        for _ in range(2):
            dm = DeviceMap(MAX_KF, N_FEAT, MAX_MP, device=card)
            dm.sync_all(st)
            for stage in ENTRY:
                dm.capture(stage, None, *args[stage])
            dm.capture_scatter(256)
            torch.cuda.synchronize()
            held.append(torch.cuda.memory_reserved(card))
            del dm
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            after.append(torch.cuda.memory_reserved(card))
        assert held[1] > after[1]
        assert after[1] == after[0]
    finally:
        if gc_on:
            gc.enable()
