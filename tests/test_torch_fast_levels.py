"""The port's per-pyramid FAST score maps (`fast.level_scores`: FAST + nonmax
+ border + per-cell high/low select, the function the CUDA kernel computes in
one launch) against the JAX package, and a plain model of the CUDA kernel's
arithmetic and index walks against the plain version. Everything is min, max,
subtract and compare, so every comparison is exact."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.ops import fast as jfast
from orbslam_jpminipc_tpu.ops.fast_pallas import fast_detect_tpu
from orbslam_jpminipc_torch.ops import extractor, fast, fast_cuda, pyramid

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")
BORDER = extractor.EDGE_THRESHOLD


def _frame(shape, seed: int) -> np.ndarray:
    """A frame with strong corners (left), weak corners that pass threshold
    7 but not 20 (middle) and a flat region (right)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128.0, np.float32)
    a, b = w // 3, 2 * w // 3
    blocks = rng.integers(0, 256, (h // 4 + 1, a // 4 + 1)).astype(np.float32)
    img[:, :a] = np.kron(blocks, np.ones((4, 4), np.float32))[:h, :a]
    weak = rng.integers(-6, 7, (h // 3 + 1, (b - a) // 3 + 1)).astype(np.float32)
    img[:, a:b] += np.kron(weak, np.ones((3, 3), np.float32))[:h, :b - a]
    return img


def _levels(shape, seed: int) -> list[torch.Tensor]:
    return pyramid.build_pyramid(torch.from_numpy(_frame(shape, seed)), 8, 1.2)


def _jax_select(lo, fast_th: float, cell: int):
    """The select of orbslam_jpminipc_tpu/ops/extractor.py:_select_level."""
    h, w = lo.shape
    hi = jnp.where(lo + 1.0 > fast_th, lo, 0.0)
    ph, pw = -h % cell, -w % cell
    hi_p = jnp.pad(hi, ((0, ph), (0, pw)))
    cell_max = hi_p.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).max(axis=(1, 3))
    has_hi = jnp.repeat(jnp.repeat(cell_max > 0, cell, axis=0), cell, axis=1)[:h, :w]
    return jnp.where(has_hi, hi, lo), has_hi


@jax.jit
def _jax_lo_both(img):
    """The reference's low-threshold map by both of its paths: jnp, and the
    Pallas kernel in interpret mode with the border mask of `fast.detect`."""
    h, w = img.shape
    by_jnp = jfast.detect(img, 7.0, border=BORDER)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    by_pallas = jnp.where(inside, fast_detect_tpu(img, 7.0, interpret=True), 0.0)
    return by_jnp, by_pallas


@pytest.fixture(scope="module")
def jax_lo():
    """(shape, seed) -> per level (jnp low map, Pallas low map), computed once."""
    cache = {}

    def get(shape, seed):
        if (shape, seed) not in cache:
            cache[shape, seed] = [
                tuple(np.asarray(x) for x in _jax_lo_both(jnp.asarray(l.numpy())))
                for l in _levels(shape, seed)]
        return cache[shape, seed]

    return get


@pytest.mark.parametrize("cell", [32, 16])
@pytest.mark.parametrize("ths", [(20.0, 7.0), (7.0, 7.0)])
@pytest.mark.parametrize("shape", [(120, 160), (150, 203)])
def test_level_scores_match_jax(jax_lo, shape, ths, cell):
    fast_th, fast_min_th = ths
    levels = _levels(shape, 3)
    before = fast_cuda.LAUNCHES
    got = fast.level_scores(levels, fast_th, fast_min_th, BORDER, cell)
    assert fast_cuda.LAUNCHES == before  # CPU tensors: the plain version
    assert len(got) == 8
    hi_cells = lo_only_cells = False
    for lvl, (g, (lo_jnp, lo_pallas)) in enumerate(zip(got, jax_lo(shape, 3))):
        np.testing.assert_array_equal(lo_jnp, lo_pallas)
        ref, has_hi = _jax_select(jnp.asarray(lo_jnp), fast_th, cell)
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref), err_msg=f"level {lvl}")
        has_hi = np.asarray(has_hi)
        hi_cells |= bool(((lo_jnp > 0) & has_hi).any())
        lo_only_cells |= bool(((lo_jnp > 0) & ~has_hi).any())
    if fast_th > fast_min_th:
        # cells with a high corner and cells with low corners only both occur
        assert hi_cells and lo_only_cells
    assert sum(int((g > 0).sum()) for g in got) > 50


# ---------------------------------------------------------------------------
# a plain model of csrc/fast.cu: the same tiles, walks and arithmetic
# ---------------------------------------------------------------------------

TILE, HALO, K_IN, K_SC, RUN, THREADS = 32, 4, 40, 34, 5, 256
DY = (-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3)
DX = (0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1)


def _win_used(r: int, k: int) -> bool:
    a = abs(k - 3)
    if a == 0:
        return True
    if a == 1:
        return r < RUN or r >= 6
    if a == 2:
        return 1 <= r < RUN + 5
    return 2 <= r < RUN + 4


def _stage(img: np.ndarray, x0: int, y0: int, vec: bool) -> np.ndarray:
    """The staged (40, 40) tile by the kernel's two walks; NaN where no
    thread wrote."""
    h, w = img.shape
    buf = np.full((K_IN, K_IN), np.nan, np.float32)
    for t in range(THREADS):
        if vec:
            row, ch = divmod(t, K_IN // 4)
            for _ in range(2):
                if row < K_IN:
                    gy, gx = y0 - HALO + row, x0 - HALO + 4 * ch
                    ok = 0 <= gy < h and 0 <= gx < w
                    buf[row, 4 * ch:4 * ch + 4] = img[gy, gx:gx + 4] if ok else 0.0
                ch += 6
                row += 25
                if ch >= K_IN // 4:
                    ch -= K_IN // 4
                    row += 1
        else:
            row, col = divmod(t, K_IN)
            for _ in range(7):
                if row < K_IN:
                    gy, gx = y0 - HALO + row, x0 - HALO + col
                    ok = 0 <= gy < h and 0 <= gx < w
                    buf[row, col] = img[gy, gx] if ok else 0.0
                col += 16
                row += 6
                if col >= K_IN:
                    col -= K_IN
                    row += 1
    return buf


def _key(x: np.ndarray) -> np.ndarray:
    """float32 -> int32 whose signed order is the float order (the kernel's
    `float_key`); its own inverse on the bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def _unkey(k: np.ndarray) -> np.ndarray:
    k = np.ascontiguousarray(k, np.int32)
    return (k ^ ((k >> 31) & np.int32(0x7FFFFFFF))).view(np.float32)


def _arcs(q: np.ndarray, centre: np.ndarray, threshold: float) -> np.ndarray:
    """(16, n) keys of the circle pixels and (n,) centre values -> (n,)
    scores, the kernel's way: 9-arcs as 3 x 3 on the keys, the centre
    subtracted once per polarity at the end."""
    def chain(first, last):
        u = first(first(q, np.roll(q, -1, 0)), np.roll(q, -2, 0))
        v = first(first(u, np.roll(u, -3, 0)), np.roll(u, -6, 0))
        w = [last(last(v[3 * i], v[3 * i + 1]), v[3 * i + 2]) for i in range(5)]
        return last(last(last(w[0], w[1]), w[2]), last(last(w[3], w[4]), v[15]))

    th = np.float32(threshold)
    bright = _unkey(chain(np.minimum, np.maximum)) - centre
    dark = -(_unkey(chain(np.maximum, np.minimum)) - centre)
    m = np.maximum(bright, dark)
    return np.where(m > th, m - np.float32(1.0), np.float32(0.0)).astype(np.float32)


def _model_tile(img, out, x0, y0, threshold, fast_th, border, select, vec):
    h, w = img.shape
    buf = _stage(img, x0, y0, vec)
    assert not np.isnan(buf).any()  # the walks cover the tile
    buf = _key(buf).astype(np.int64)  # to_keys; int64 so that NaN marks can ride along
    sc = np.full((K_SC, K_SC), np.nan, np.float32)
    t = np.arange(7 * K_SC)                      # the threads that score
    strip, c = t // K_SC, t % K_SC
    r0 = np.minimum(strip * RUN, K_SC - RUN)
    rr, kk = np.meshgrid(np.arange(RUN + 6), np.arange(7), indexing="ij")
    win = buf[r0[:, None, None] + rr, c[:, None, None] + kk]      # (t, 11, 7)
    used = np.array([[_win_used(r, k) for k in range(7)] for r in range(RUN + 6)])
    unread = np.int64(1) << 40
    win = np.where(used, win, unread)
    p = np.arange(RUN)
    q = np.stack([win[:, p + 3 + dy, 3 + dx] for dy, dx in zip(DY, DX)])  # (16, t, RUN)
    assert not (q == unread).any()  # the window holds every circle pixel
    centre = _unkey(win[:, p + 3, 3].astype(np.int32).reshape(-1))
    s = _arcs(q.astype(np.int32).reshape(16, -1), centre, threshold).reshape(-1, RUN)
    for i in range(len(t)):
        for q in range(RUN):
            gy, gx = y0 - 1 + r0[i] + q, x0 - 1 + c[i]
            sc[r0[i] + q, c[i]] = s[i, q] if 0 <= gy < h and 0 <= gx < w else -np.inf
    assert not np.isnan(sc).any()
    lo = np.zeros((TILE, TILE), np.float32)
    in_img = np.zeros((TILE, TILE), bool)
    for t in range(THREADS):
        nx, ny0 = t & 31, (t >> 5) * 4
        v = sc[ny0:ny0 + 6, nx:nx + 3]
        for j in range(4):
            gy, gx = y0 + ny0 + j, x0 + nx
            c = v[j + 1, 1]
            nmax = max(v[j].max(), v[j + 1, 0], v[j + 1, 2], v[j + 2].max())
            inside = border <= gy < h - border and border <= gx < w - border
            lo[ny0 + j, nx] = c if inside and c > nmax and c > 0 else 0.0
            in_img[ny0 + j, nx] = gy < h and gx < w
    hi = np.where(lo + np.float32(1.0) > np.float32(fast_th), lo, np.float32(0.0))
    use_hi = bool(select and (hi > 0).any())
    res = hi if use_hi else lo
    ys, xs = np.nonzero(in_img)
    out[y0 + ys, x0 + xs] = res[ys, xs]
    return use_hi


def _model_levels(levels, threshold, fast_th, border, select):
    outs, votes = [], []
    for img in levels:
        h, w = img.shape
        out = np.full((h, w), np.nan, np.float32)
        for y0 in range(0, h, TILE):
            for x0 in range(0, w, TILE):
                votes.append(_model_tile(img, out, x0, y0, threshold, fast_th, border,
                                         select, vec=(w % 4 == 0)))
        assert not np.isnan(out).any()  # every pixel written
        outs.append(out)
    return outs, votes


@pytest.mark.parametrize("shape,seed", [((70, 100), 0), ((64, 96), 1), ((45, 77), 2),
                                        ((32, 64), 3), ((33, 65), 4), ((96, 42), 5)])
def test_kernel_model_matches_plain(shape, seed):
    """The kernel's tiling, staging walks, register window, 3 x 3 arcs on
    integer keys, nonmax and per-tile vote, modelled thread by thread, equal
    the plain version: with the select (border 19 and 5) and without it
    (`fast_detect`, border 0, where the image edge shows)."""
    imgs = [_frame(shape, seed),
            # a small level with negative values too: the keys must order them
            (np.random.default_rng(seed).random((33, 41)) * 300.0 - 100.0).astype(np.float32)]
    levels = [torch.from_numpy(i) for i in imgs]
    for border, fast_th in ((5, 20.0), (BORDER, 20.0), (5, 7.0)):
        got, votes = _model_levels(imgs, 7.0, fast_th, border, True)
        ref = fast.level_scores(levels, fast_th, 7.0, border, 32)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r.numpy())
        if border == 5 and fast_th == 20.0:
            assert True in votes and False in votes  # both arms of the vote
    got, _ = _model_levels(imgs, 7.0, 0.0, 0, False)
    for g, l in zip(got, levels):
        ref = fast.nonmax_3x3(fast.fast_score_map(l, 7.0))
        np.testing.assert_array_equal(g, ref.numpy())
        assert (ref > 0).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(40, 64), (57, 83)])
def test_key_arcs_match_score_map(shape, seed):
    """The kernel's arcs (integer keys, 3-input grouping, the centre
    subtracted at the end) equal the
    plain 16 x 9 arcs on integer, non-integer and negative intensities."""
    rng = np.random.default_rng(seed)
    for img in (rng.integers(0, 256, shape).astype(np.float32),
                (rng.random(shape) * 255.0).astype(np.float32),
                (rng.random(shape) * 200.0 - 100.0).astype(np.float32),
                _frame(shape, seed)):
        t = torch.from_numpy(img)
        q = _key(fast._circle_stack(t).numpy().reshape(16, -1))
        for threshold in (7.0, 20.0):
            ref = fast.fast_score_map(t, threshold).numpy()
            got = _arcs(q, img.reshape(-1), threshold).reshape(shape)
            np.testing.assert_array_equal(got, ref)


def test_float_key_orders_like_floats():
    x = np.array([-np.inf, -255.0, -1.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 254.99998, 255.0, np.inf],
                 np.float32)
    k = _key(x)
    assert (np.diff(k.astype(np.int64)) > 0).all()
    assert _key(np.zeros(1, np.float32))[0] == 0  # the zero fill needs no transform
    np.testing.assert_array_equal(_unkey(k).view(np.int32), x.view(np.int32))


# ---------------------------------------------------------------------------
# the extractor through the one call, and the wrapper's contract
# ---------------------------------------------------------------------------

def _level_score_per_level(img, fast_th, fast_min_th, cell):
    """The extractor's per-level score as it was before `level_scores`:
    `detect`, then the select with tensor operations."""
    import torch.nn.functional as F

    h, w = img.shape
    lo = fast.detect(img, fast_min_th, border=BORDER)
    hi = torch.where(lo + 1.0 > fast_th, lo, torch.zeros_like(lo))
    ph, pw = -h % cell, -w % cell
    hi_p = F.pad(hi, (0, pw, 0, ph))
    cell_max = hi_p.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).amax(dim=(1, 3))
    has_hi = (cell_max > 0).repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(has_hi, hi, lo)


def test_extract_same_features_through_one_call(monkeypatch):
    img = torch.from_numpy(np.load(FIXTURE)["images"][0].astype(np.float32))
    calls = []
    real = fast.level_scores

    def counting(levels, *a, **k):
        calls.append(len(levels))
        return real(levels, *a, **k)

    monkeypatch.setattr(fast, "level_scores", counting)
    new = extractor.extract(img, n_features=1000)
    assert calls == [8]  # one call for all levels
    monkeypatch.setattr(
        fast, "level_scores",
        lambda levels, fast_th, fast_min_th, border, cell: [
            _level_score_per_level(l, fast_th, fast_min_th, cell) for l in levels])
    old = extractor.extract(img, n_features=1000)
    for name in ("xy", "level", "desc", "valid", "angle", "response"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name
    assert int(new.valid.sum()) > 500


def test_level_score_one_level_and_cell_select():
    img = torch.from_numpy(_frame((90, 130), 4))
    for cell in (32, 16):
        one = extractor._level_score(img, 20.0, 7.0, cell)
        assert torch.equal(one, _level_score_per_level(img, 20.0, 7.0, cell))
        lo = fast.detect(img, 7.0, border=BORDER)
        assert torch.equal(one, fast.cell_select(lo, 20.0, cell))
    xy, resp, valid = extractor._select_level(img, 40, 20.0, 7.0, 32)
    assert xy.shape == (40, 2) and int(valid.sum()) > 0


@pytest.mark.parametrize("case", ["cpu", "dtype", "noncontiguous", "threshold", "dims",
                                  "empty", "too_many", "mixed"])
def test_cuda_wrapper_rejects_without_launching(case):
    good = torch.zeros((32, 48), dtype=torch.float32)
    levels, ths, exc = [good], (20.0, 7.0), ValueError
    if case == "cpu":
        pass  # a CPU tensor never reaches the kernel
    elif case == "dtype":
        levels = [good.double()]
    elif case == "noncontiguous":
        levels = [good.t()]
    elif case == "threshold":
        ths = (20.0, 0.0)
    elif case == "dims":
        levels = [good[None]]
    elif case == "empty":
        levels = []
    elif case == "too_many":
        levels = [good] * (fast_cuda.MAX_LEVELS + 1)
    elif case == "mixed":
        levels = [good, good.to("meta")]
    before = fast_cuda.LAUNCHES
    with pytest.raises(exc):
        fast_cuda.fast_level_scores(levels, ths[0], ths[1], BORDER, 32)
    assert fast_cuda.LAUNCHES == before
    if case == "mixed":
        with pytest.raises(ValueError):
            fast.level_scores(levels, 20.0, 7.0, BORDER, 32)


def test_table_layout_matches_source():
    """The ctypes table mirrors the struct in csrc/fast.cu (two pointers and
    six ints per level; levels, then two ints)."""
    import ctypes

    assert ctypes.sizeof(fast_cuda._Level) == 2 * 8 + 6 * 4
    assert ctypes.sizeof(fast_cuda._Table) == fast_cuda.MAX_LEVELS * 40 + 8
    src = fast_cuda.SOURCE.read_text()
    assert f"kMaxLevels = {fast_cuda.MAX_LEVELS};" in src
    assert f"kTile = {fast_cuda.TILE};" in src
    order = [src.index(f" {name};") for name in
             ("in", "out", "H, W", "tiles_x", "tile_begin", "tile_end", "vec")]
    assert order == sorted(order)
    assert [f[0] for f in fast_cuda._Level._fields_] == [
        "inp", "out", "H", "W", "tiles_x", "tile_begin", "tile_end", "vec"]
