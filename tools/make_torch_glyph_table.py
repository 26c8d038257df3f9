"""Record the glyph table the port's `io/viz.py` draws its text with:
orbslam_jpminipc_torch/data/glyphs_hershey_plain.npz.

The reference draws its banner with `cv2.putText(..., FONT_HERSHEY_PLAIN,
1.0, color, 1)`. The cv2 this table is recorded from (5.0) renders that
call with an antialiased outline font: every glyph is a coverage bitmap
placed at an integer pen position, the pen advances by a whole number of
pixels a character (no kerning), and each glyph is blended onto the image
in turn, dst = (dst (255 - a) + color a + 127) // 255. This tool renders
each printable ASCII character alone, white on black (where the pixel IS
the coverage), records its bitmap and its offset from the text origin,
measures each character's advance (the position of an 'H' written after
it), and checks that the table, composed that way, gives cv2's pixels on
random strings and on the reference's banners. Run it where cv2 is:

    python tools/make_torch_glyph_table.py
"""
from __future__ import annotations

import os
import random

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "glyphs_hershey_plain.npz")
FONT = cv2.FONT_HERSHEY_PLAIN
X0, Y0, W, H = 40, 40, 1400, 64
CODES = list(range(32, 127))


def render(text: str, x: int = X0) -> np.ndarray:
    im = np.zeros((H, W), np.uint8)
    cv2.putText(im, text, (x, Y0), FONT, 1.0, 255, 1)
    return im


def glyph(c: str):
    """(dy, dx, bitmap) of one character relative to the text origin."""
    im = render(c)
    ys, xs = np.nonzero(im)
    if len(ys) == 0:
        return 0, 0, np.zeros((0, 0), np.uint8)
    return (int(ys.min() - Y0), int(xs.min() - X0),
            im[ys.min():ys.max() + 1, xs.min():xs.max() + 1].copy())


def advance(c: str, h_glyph) -> int:
    """The pen's advance over `c`: where an 'H' written after it lands."""
    im = render(c + "H")
    dy, dx, g = h_glyph
    hh, ww = g.shape
    y = Y0 + dy
    for off in range(0, 60):
        x = X0 + off + dx
        if np.array_equal(im[y:y + hh, x:x + ww][:, -2:], g[:, -2:]) and \
                np.array_equal(im[y:y + hh, x + ww:x + ww + 3], np.zeros((hh, 3), np.uint8)):
            return off
    raise AssertionError(f"no advance found for {c!r}")


def main():
    glyphs = {c: glyph(chr(c)) for c in CODES}
    adv = {c: advance(chr(c), glyphs[ord("H")]) for c in CODES}
    dy = np.array([glyphs[c][0] for c in CODES], np.int32)
    dx = np.array([glyphs[c][1] for c in CODES], np.int32)
    hw = np.array([glyphs[c][2].shape for c in CODES], np.int32)
    offsets = np.concatenate([[0], np.cumsum(hw[:, 0] * hw[:, 1])]).astype(np.int32)
    alpha = np.concatenate([glyphs[c][2].reshape(-1) for c in CODES]).astype(np.uint8)
    np.savez_compressed(OUT, codes=np.array(CODES, np.int32), advance=np.array(
        [adv[c] for c in CODES], np.int32), dy=dy, dx=dx, hw=hw, offsets=offsets, alpha=alpha,
        cv2_version=np.array(cv2.__version__))

    # the check: the port's composition against cv2 on random strings and
    # on the reference's banners, white on a black band as draw_frame does
    import sys
    sys.path.insert(0, REPO)
    from orbslam_jpminipc_torch.io import viz

    viz._glyph_table.cache_clear()
    rng = random.Random(0)
    texts = ["".join(rng.choice([chr(c) for c in CODES]) for _ in range(30)) for _ in range(40)]
    texts += ["SLAM ON | KFs: 12 | MPs: 3456 | tracked: 789", "TRACK LOST - RELOCALIZING",
              "WAITING FOR IMAGES", "TRYING TO INITIALIZE"]
    bad = 0
    for t in texts:
        ref = np.zeros((H, W, 3), np.uint8)
        cv2.putText(ref, t, (6, Y0), FONT, 1.0, (255, 255, 255), 1)
        got = np.zeros((H, W, 3), np.uint8)
        viz.put_text(got, t, (6, Y0), (255, 255, 255))
        bad += int((got != ref).sum())
    print(f"{len(CODES)} glyphs, {alpha.size} coverage bytes -> {OUT}; "
          f"pixels differing from cv2 {cv2.__version__} on {len(texts)} strings: {bad}")
    if bad:
        raise SystemExit("the table does not reproduce cv2's text")


if __name__ == "__main__":
    main()
