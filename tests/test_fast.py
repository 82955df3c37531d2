"""FAST-9 strength + 3x3 NMS (ops/fast.py) against a brute-force numpy reference.

The reference applies the definitions directly: for every pixel, the 16 Bresenham
circle differences (edge-replicated at the border), the strength as the max over
the 16 contiguous 9-arcs of the arc's min (bright) or of the negated arc's min
(dark), then keeps a pixel only where it is strictly greater than all 8
neighbours (reference: cv::FAST in ORBextractor::Compute,
src/orb_features/orb_extractor.cpp:750-757).
"""

import jax
import numpy as np
import pytest

from slam_framework_tpu.ops import fast


def _fast_nms_reference(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    pad = np.pad(img.astype(np.float64), 3, mode="edge")
    diffs = np.stack(
        [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in fast.CIRCLE]
    ) - img
    strength = np.full((h, w), -np.inf)
    for start in range(16):
        arc = diffs[[(start + k) % 16 for k in range(fast.ARC_LEN)]]
        strength = np.maximum(strength, arc.min(axis=0))    # brighter arc
        strength = np.maximum(strength, (-arc).min(axis=0))  # darker arc
    padded = np.pad(strength, 1, constant_values=-np.inf)
    keep = np.ones((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= strength > padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return np.where(keep, strength, 0.0)


@pytest.mark.parametrize(
    "shape", [(64, 96), (75, 141), (376, 1241)], ids=["small", "not-multiple-of-8", "kitti"]
)
def test_fast_nms_matches_bruteforce(shape):
    rng = np.random.default_rng(sum(shape))
    # smoothed noise: corners with distinct strengths, not a field of ties
    noise = rng.integers(0, 256, (shape[0] // 4 + 2, shape[1] // 4 + 2)).astype(np.float64)
    img = np.kron(noise, np.ones((4, 4)))[: shape[0], : shape[1]]
    img = np.clip(img + rng.normal(0, 12, shape), 0, 255).round().astype(np.float32)
    got = np.asarray(jax.jit(lambda x: fast.nms3x3(fast.fast_strength_map(x)))(img))
    want = _fast_nms_reference(img)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (want > 20).sum() > 0  # the image must contain corners above the ORB threshold


@pytest.mark.gpu
def test_fast_nms_gpu_matches_cpu(gpu_device):
    """The compiled GPU program gives the CPU's map bit for bit: the strength is
    a min/max of differences of the same float32 pixels."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (376, 1241)).astype(np.float32)
    f = jax.jit(lambda x: fast.nms3x3(fast.fast_strength_map(x)))
    got = np.asarray(f(jax.device_put(img, gpu_device)))
    want = np.asarray(f(jax.device_put(img, jax.devices("cpu")[0])))
    np.testing.assert_array_equal(got, want)
