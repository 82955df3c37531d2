"""Synthetic-world renderer primitives against OpenCV, which the renderer no
longer needs: bilinear texture lookup with wrapped or reflected borders, bicubic
upsampling of the texture noise, and area-averaging mip downsampling."""

import numpy as np
import pytest

from slam_framework_tpu.io import synthetic

cv2 = pytest.importorskip("cv2")


def _texture(rng, h=301, w=777):
    noise = rng.standard_normal((h // 8 + 2, w // 8 + 2)).astype(np.float32)
    smooth = synthetic.resize_cubic(noise, h, w)
    return np.clip(128 + 40 * smooth, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("wrap", [True, False], ids=["remap-wrap", "remap-reflect"])
def test_remap_linear_matches_cv2(wrap):
    rng = np.random.default_rng(11)
    tex = _texture(rng)
    # columns run past both ends of the strip; rows stay inside, as in _sample_mips
    mapx = rng.uniform(-60.0, tex.shape[1] + 60.0, (240, 640)).astype(np.float32)
    mapy = rng.uniform(0.0, tex.shape[0] - 1.001, (240, 640)).astype(np.float32)
    border = cv2.BORDER_WRAP if wrap else cv2.BORDER_REFLECT
    want = cv2.remap(tex, mapx, mapy, cv2.INTER_LINEAR, borderMode=border).astype(np.float32)
    got = synthetic.remap_linear(tex, mapx, mapy, wrap)
    d = np.abs(got - want)
    # cv2 quantizes coordinates to 1/32 px; the lookup here is exact
    assert d.max() <= 1.0, d.max()
    assert (d > 0).mean() < 0.01


@pytest.mark.parametrize("kind", ["cubic-resize", "area-downsample"])
def test_resize_matches_cv2(kind):
    rng = np.random.default_rng(12)
    if kind == "cubic-resize":
        src = rng.standard_normal((30, 200)).astype(np.float32)
        want = cv2.resize(src, (1500, 120), interpolation=cv2.INTER_CUBIC)
        got = synthetic.resize_cubic(src, 120, 1500)
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        for h, w in ((300, 776), (301, 777)):  # even: 2x2 means; odd: fractional spans
            src = rng.integers(0, 256, (h, w)).astype(np.uint8)
            want = cv2.resize(src, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
            got = synthetic.downsample_area(src, h // 2, w // 2)
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (h, w, d.max(), (d > 0).mean())
