"""PyTorch port vs the JAX package: io/dataset.py (trajectories, textures,
homographies, rendered frames, the TUM reader and writer, photometric
augmentation) and the port's PNG codec. The reference calls cv2 for the
textures, the warps and the PNGs; the port rebuilds cv2's arithmetic, so
cv2 (present here, absent on the card's machine) is the oracle."""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.io import dataset as jds
from orbslam_jpminipc_torch.io import dataset as tds
from orbslam_jpminipc_torch.io import png
from orbslam_jpminipc_torch.ops import extractor as text

torch.set_num_threads(2)

# Rendered frames and textures are bit-equal to the reference's (measured on
# 76 frames of xyz seed 3, loop and orbit seed 0, and the textures of seeds
# 0-3). cv2's bicubic resize is rebuilt exactly where no tap is clamped; in
# the border bands its summation order was not pinned down and the last bit
# differs on a share of the floats (RESIZE_BORDER_SHARE), which the uint8
# textures built on it do not show.
RESIZE_BORDER_SHARE = 0.05
# PhotometricAugment: the blur is cv2.filter2D's correlation as F.conv2d,
# whose float32 sums may round the last bit differently before truncation
PHOTO_EQUAL_SHARE = 0.9999
PHOTO_MAX_DIFF = 1


@pytest.fixture(scope="module")
def xyz3():
    return (jds.SyntheticSequence(n_frames=45, trajectory="xyz", seed=3),
            tds.SyntheticSequence(n_frames=45, trajectory="xyz", seed=3, device="cpu"))


@pytest.mark.parametrize("kind,n", [("xyz", 300), ("forward", 40), ("loop", 400), ("orbit", 300)])
def test_trajectories_and_timestamps_equal(kind, n):
    ref = jds.SyntheticSequence._trajectory(None, n, kind)
    got = tds.SyntheticSequence._trajectory(None, n, kind)
    assert len(ref) == len(got) == n
    for (Ra, ta), (Rb, tb) in zip(ref, got):
        assert Ra.dtype == Rb.dtype == np.float32
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)


def test_tile_quad_equal():
    corners = np.array([[-2, -1.5, 3], [2, -1.5, 3], [2, 1.2, 3], [-2, 1.2, 3]], np.float32)
    tex = np.random.default_rng(0).integers(0, 256, (1024, 1024)).astype(np.uint8)
    ref, got = jds._tile_quad(corners, tex), tds._tile_quad(corners, tex)
    assert len(ref) == len(got) == 100
    for (ca, ta), (cb, tb) in zip(ref, got):
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("size,blobs", [(1024, 900), (256, 120)])
def test_make_texture_equal(seed, size, blobs):
    ref = jds._make_texture(np.random.default_rng(seed), size, blobs)
    got = tds._make_texture(np.random.default_rng(seed), size, blobs)
    assert got.dtype == np.uint8 and got.shape == (size, size)
    d = np.abs(ref.astype(int) - got.astype(int))
    assert d.max() == 0, ((d == 0).mean(), d.max())


# (octave, size, share of interior floats allowed to differ): measured 0
# everywhere but 128 -> 256, where cv2 takes another order on 0.39 %
@pytest.mark.parametrize("octave,size,inner_share", [
    (8, 1024, 0.0), (32, 1024, 0.0), (128, 1024, 0.0), (8, 256, 0.0), (32, 256, 0.0),
    (128, 256, 0.005)])
def test_cubic_resize_against_cv2(octave, size, inner_share):
    small = np.random.default_rng(octave).normal(0, 1, (octave, octave)).astype(np.float32)
    ref = cv2.resize(small, (size, size), interpolation=cv2.INTER_CUBIC)
    got = tds._cubic_resize(small, size)
    sx, _ = tds._cubic_taps(octave, size)
    inner = (sx - 1 >= 0) & (sx + 2 <= octave - 1)
    assert (got[np.ix_(inner, inner)] != ref[np.ix_(inner, inner)]).mean() <= inner_share
    # measured: at most 1.95 % of all floats, by at most 4.8e-7
    assert (got != ref).mean() <= RESIZE_BORDER_SHARE
    assert np.abs(got - ref).max() <= 4 * np.spacing(np.abs(ref).max())


def test_gaussian_blur_equal_to_cv2():
    img = np.random.default_rng(0).integers(0, 256, (97, 131)).astype(np.uint8)
    np.testing.assert_array_equal(tds._gaussian_blur_3x3(img, 0.7),
                                  cv2.GaussianBlur(img, (3, 3), 0.7))


def test_homographies_match_cv2(xyz3):
    ref, got = xyz3
    worst, n = 0.0, 0
    for i in (0, 13, 27):
        R, t = ref.poses[i]
        for corners, tex in ref.quads:
            Ha = ref._plane_homography(R, t, corners, tex.shape)
            Hb = got._plane_homography(R, t, corners, tex.shape)
            assert (Ha is None) == (Hb is None)
            if Ha is not None:
                worst = max(worst, float(np.abs(Ha - Hb).max() / np.abs(Ha).max()))
                n += 1
    assert n > 1000
    assert worst <= 1e-9, worst


def _equal_share(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return float((d == 0).mean()), int(d.max())


def test_render_xyz_equal(xyz3):
    ref, got = xyz3
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(ref.quads, got.quads))
    for i in (0, 13, 27):
        img = got.render(i)
        assert img.dtype == torch.uint8 and tuple(img.shape) == (480, 640)
        assert _equal_share(ref.render(i), img.numpy()) == (1.0, 0), i


@pytest.mark.parametrize("kind,n,frame", [("loop", 400, 150), ("orbit", 300, 200)])
def test_render_loop_orbit_equal(kind, n, frame):
    ref = jds.SyntheticSequence(n_frames=n, trajectory=kind, seed=0)
    got = tds.SyntheticSequence(n_frames=n, trajectory=kind, seed=0, device="cpu")
    assert len(got.quads) == len(ref.quads)
    assert _equal_share(ref.render(frame), got.render(frame).numpy()) == (1.0, 0)
    img, ts, (R, t) = got.get(frame)
    assert ts == pytest.approx(frame / 30.0)
    np.testing.assert_array_equal(R, ref.poses[frame][0])


def test_extract_on_port_and_cv2_frames(xyz3):
    ref, got = xyz3
    a = text.extract(torch.from_numpy(ref.render(13)).float(), n_features=600)
    b = text.extract(got.render(13).float(), n_features=600)
    valid = a.valid.numpy() & b.valid.numpy()
    same = np.all(a.xy.numpy() == b.xy.numpy(), axis=1)[valid].mean()
    # measured: 1.0 (the frames are equal)
    assert valid.sum() > 500 and same >= 0.99, same


# ---- PNG ------------------------------------------------------------------

def _png_bytes(img: np.ndarray, filters) -> bytes:
    """A PNG whose rows are filtered with the given filter types (cycled)."""
    h = img.shape[0]
    color = 0 if img.ndim == 2 else 2
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            p = np.zeros_like(cur)
        elif f == 1:
            p = a
        elif f == 2:
            p = prev
        elif f == 3:
            p = (a + prev) >> 1
        else:
            pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
            p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + ((cur - p) & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(typ, body):
        return struct.pack(">I", len(body)) + typ + body + struct.pack(
            ">I", zlib.crc32(typ + body) & 0xFFFFFFFF)

    w = img.shape[1]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_cv2_written_reads_equal(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (120, 160) if channels == 1 else (120, 160, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[40:60] = img[40:60, :1]          # flat rows and grey pixels too
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(png.read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_each_filter_reads_equal(tmp_path, channels, filters):
    rng = np.random.default_rng(7)
    shape = (23, 37) if channels == 1 else (23, 37, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(img, filters))
    got = png.read_gray(str(path))
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    if channels == 1:
        np.testing.assert_array_equal(got, img)
    # the plain version agrees with the native one
    raw = np.frombuffer(zlib.decompress(b"".join(
        b for t, b in png._chunks(path.read_bytes()) if t == b"IDAT")), np.uint8)
    np.testing.assert_array_equal(
        png.unfilter_py(raw, shape[0], shape[1] * channels, channels),
        png._unfilter(raw, shape[0], shape[1] * channels, channels))


def test_png_write_reads_back_in_cv2(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (48, 64)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    png.write_gray(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_gray(path), img)


# ---- TUM directories --------------------------------------------------------

def test_write_tum_sequence_reads_back_in_both(tmp_path, xyz3):
    ref, got = xyz3
    gt = tds.write_tum_sequence(str(tmp_path / "port"), got, n=4)
    gt_ref = jds.write_tum_sequence(str(tmp_path / "ref"), ref, n=4)
    assert sorted(gt) == sorted(gt_ref)
    for d in ("port", "ref"):
        a = jds.TumDataset(str(tmp_path / d))
        b = tds.TumDataset(str(tmp_path / d), device="cpu")
        assert a.entries == b.entries and len(b) == 4
        for i in range(4):
            ia, ta, _ = a.get(i)
            ib, tb, _ = b.get(i)
            assert ta == tb
            np.testing.assert_array_equal(ib.numpy(), ia)
            np.testing.assert_array_equal(ib.numpy(), ref.render(i))


def test_tum_skips_comments_and_blanks(tmp_path):
    (tmp_path / "rgb.txt").write_text(
        "# header\n\n1.5 rgb/a.png\n# mid comment\n2.5 rgb/b.png\n")
    ds = tds.TumDataset(str(tmp_path), device="cpu")
    assert len(ds) == 2
    assert ds.entries[0] == (1.5, "rgb/a.png")
    assert ds.entries == jds.TumDataset(str(tmp_path)).entries


# ---- photometric augmentation ---------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(blur_px=1.5), dict(blur_px=4.0), dict(noise_sigma=4.0), dict(exposure_amp=0.15),
    dict(vignette=0.3), dict(blur_px=1.5, noise_sigma=4.0, exposure_amp=0.15, vignette=0.3),
], ids=["blur", "blur4", "noise", "exposure", "vignette", "combined"])
def test_photometric_augment(xyz3, kw):
    ref, got = xyz3
    a = jds.PhotometricAugment(ref, seed=1, **kw)
    b = tds.PhotometricAugment(got, seed=1, **kw)
    for i in (0, 5, 17):
        x, tx, _ = a.get(i)
        y, ty, _ = b.get(i)
        assert y.dtype == torch.uint8 and tx == ty
        share, worst = _equal_share(x, y.numpy())
        # measured: 1.0 / 0 for each effect alone, 0.9999967 / 1 combined
        assert share >= PHOTO_EQUAL_SHARE and worst <= PHOTO_MAX_DIFF, (i, share, worst)
