"""The stream: periodic trajectories, frames reproducible from the seed,
covered-lens episodes where the mix puts them."""
import numpy as np

from slam_bench.scene import trajectory_poses
from slam_bench.traffic import Occlusion, Stream, load_mix

CAM = {"width": 96, "height": 72, "fps": 30.0, "fx": 78.0, "fy": 78.0, "cx": 47.5, "cy": 35.5}


def test_trajectories_are_periodic():
    for kind in ("xyz", "loop", "orbit"):
        p = trajectory_poses(40, kind)
        twice = trajectory_poses(80, kind)
        # the phase is (i mod period) / period: half the period's frames of a
        # trajectory twice as long land on every frame of the short one
        for i in range(40):
            np.testing.assert_allclose(p[i][0], twice[2 * i][0], atol=1e-6)
            np.testing.assert_allclose(p[i][1], twice[2 * i][1], atol=1e-6)


def test_frames_are_periodic_and_reproducible_from_the_seed():
    mix = {"trajectory": "xyz", "period": 6}
    a = Stream(mix, CAM, 2 ** 31 + 5, "cpu")
    b = Stream(mix, CAM, 2 ** 31 + 5, "cpu")
    c = Stream(mix, CAM, 2 ** 31 + 6, "cpu")
    for i in range(8):
        ia, ts, clean = a.frame(i)
        assert clean and ts == i / 30.0
        assert ia.dtype == np.uint8 and ia.shape == (72, 96)
        np.testing.assert_array_equal(ia, b.frame(i)[0])
        np.testing.assert_array_equal(ia, a.frame(i + 6)[0])
        np.testing.assert_array_equal(a.center(i), a.center(i + 6))
    assert any(not np.array_equal(a.frame(i)[0], c.frame(i)[0]) for i in range(6))


def test_occlusion_episodes():
    o = Occlusion(**load_mix("occlusion")["occlusion"])
    covered = [i for i in range(400) if o.covered(i)]
    assert covered[:8] == [150, 151, 152, 153, 195, 196, 197, 198]
    mix = {"trajectory": "xyz", "period": 6,
           "occlusion": {"first": 2, "every": 5, "frames": 2, "mean_dn": 12.0, "sigma_dn": 3.0}}
    s = Stream(mix, CAM, 11, "cpu")
    dark = [s.frame(i) for i in (2, 3, 7)]
    assert all(not clean for _, _, clean in dark)
    for img, _, _ in dark:
        assert abs(float(img.mean()) - 12.0) < 1.0 and 2.0 < float(img.std()) < 4.0
    assert s.frame(4)[2] and s.frame(5)[2]
    np.testing.assert_array_equal(dark[0][0], Stream(mix, CAM, 11, "cpu").frame(2)[0])
