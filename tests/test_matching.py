"""Tests for the matmul Hamming formulation, gated matcher, and stereo matching."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from slam_framework_tpu.config import OrbConfig
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.ops import extractor, pyramid, stereo_match


def rand_desc(rng, n):
    return jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32))


def test_hamming_matrix_matches_numpy_popcount(rng):
    a = rand_desc(rng, 64)
    b = rand_desc(rng, 96)
    H = np.asarray(hamming.hamming_matrix(a, b))
    an = np.asarray(a)
    bn = np.asarray(b)
    for i in [0, 13, 63]:
        for j in [0, 50, 95]:
            expected = sum(bin(int(an[i, k]) ^ int(bn[j, k])).count("1") for k in range(8))
            assert H[i, j] == expected


def test_hamming_identity_zero(rng):
    a = rand_desc(rng, 32)
    H = np.asarray(hamming.hamming_matrix(a, a))
    assert np.all(np.diag(H) == 0)
    assert np.all(H >= 0) and np.all(H <= 256)
    np.testing.assert_array_equal(H, H.T)


def test_hamming_pairwise_consistent(rng):
    a = rand_desc(rng, 40)
    b = rand_desc(rng, 40)
    p = np.asarray(hamming.hamming_pairwise(a, b))
    H = np.asarray(hamming.hamming_matrix(a, b))
    np.testing.assert_array_equal(p, np.diag(H))


def test_gated_match_basic(rng):
    a = rand_desc(rng, 10)
    # b = a with a few bit flips: best match must be the aligned index
    bn = np.asarray(a).copy()
    bn[:, 0] ^= 0b111  # 3-bit flips
    b = jnp.asarray(bn)
    res = matcher.gated_match(hamming.hamming_matrix(a, b), max_dist=50)
    np.testing.assert_array_equal(np.asarray(res.idx), np.arange(10))
    assert np.all(np.asarray(res.dist) == 3)


def test_gated_match_gate_blocks(rng):
    a = rand_desc(rng, 6)
    gate = jnp.zeros((6, 6), bool)
    res = matcher.gated_match(hamming.hamming_matrix(a, a), gate, max_dist=256)
    assert not np.any(np.asarray(res.valid))
    assert np.all(np.asarray(res.idx) == -1)


def test_gated_match_nn_ratio(rng):
    # two identical train descriptors -> second best == best -> ratio test fails
    a = rand_desc(rng, 1)
    b = jnp.concatenate([a, a], axis=0)
    res = matcher.gated_match(hamming.hamming_matrix(a, b), nn_ratio=0.9, max_dist=256)
    assert not bool(res.valid[0])


def test_gated_match_mutual(rng):
    an = np.zeros((2, 8), np.uint32)
    bn = np.zeros((1, 8), np.uint32)
    an[1, 0] = 0xFF  # row 1 is 8 bits away; row 0 identical
    res = matcher.gated_match(
        hamming.hamming_matrix(jnp.asarray(an), jnp.asarray(bn)), mutual=True, max_dist=256
    )
    assert bool(res.valid[0]) and not bool(res.valid[1])


def test_resolve_duplicate_columns():
    res = matcher.MatchResult(
        idx=jnp.asarray([2, 2, 1], jnp.int32),
        dist=jnp.asarray([10, 5, 7], jnp.int32),
        valid=jnp.asarray([True, True, True]),
    )
    out = matcher.resolve_duplicate_columns(res, num_cols=4)
    np.testing.assert_array_equal(np.asarray(out.idx), [-1, 2, 1])


def test_rotation_consistency_keeps_dominant(rng):
    n = 100
    angle_a = jnp.zeros(n)
    # 90 matches at delta ~0, 10 outliers at delta ~pi
    angle_b = jnp.asarray(np.where(np.arange(n) < 90, 0.01, np.pi).astype(np.float32))
    res = matcher.MatchResult(
        idx=jnp.arange(n, dtype=jnp.int32),
        dist=jnp.zeros(n, jnp.int32),
        valid=jnp.ones(n, bool),
    )
    out = matcher.rotation_consistency(angle_a, angle_b, res)
    kept = np.asarray(out.valid)
    assert kept[:90].all()
    # the outlier bin has 10 >= 0.1*90 -> reference keeps it as a top-3 bin
    assert kept.sum() == 100
    # now with fewer outliers (below the 0.1x guard) they are dropped
    angle_b2 = jnp.asarray(np.where(np.arange(n) < 95, 0.01, np.pi).astype(np.float32))
    out2 = matcher.rotation_consistency(angle_a, angle_b2, res)
    kept2 = np.asarray(out2.valid)
    assert kept2[:95].all() and not kept2[95:].any()


KITTI_K = Intrinsics(fx=718.856, fy=718.856, cx=320.0, cy=120.0, bf=386.1448)


@pytest.fixture(scope="module")
def stereo_pair():
    """Synthetic fronto-parallel scene: right image is left shifted by disparity."""
    rng = np.random.default_rng(3)
    h, w = 240, 640
    base = np.zeros((h, w), np.uint8)
    for _ in range(120):
        x, y = int(rng.integers(30, w - 60)), int(rng.integers(10, h - 40))
        bw, bh = int(rng.integers(6, 30)), int(rng.integers(6, 30))
        cv2.rectangle(base, (x, y), (x + bw, y + bh), int(rng.integers(40, 255)), -1)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    depth = 15.0  # meters, uniform -> disparity = bf / z
    disp = KITTI_K.bf / depth
    M = np.float32([[1, 0, -disp], [0, 1, 0]])
    right = cv2.warpAffine(base, M, (w, h))
    return base, right, disp, depth


def test_stereo_matching_recovers_uniform_disparity(stereo_pair):
    left_img, right_img, disp_true, depth_true = stereo_pair
    cfg = OrbConfig(num_features=300, num_levels=4)
    ext = extractor.OrbExtractor(cfg)
    fl = ext(jnp.asarray(left_img))
    fr = ext(jnp.asarray(right_img))
    lp = pyramid.build_pyramid(jnp.asarray(left_img, jnp.float32), 4, 1.2)
    rp = pyramid.build_pyramid(jnp.asarray(right_img, jnp.float32), 4, 1.2)
    sm = stereo_match.match_stereo(fl, fr, lp, rp, KITTI_K, ext.scales)
    d = np.asarray(sm.depth)
    ur = np.asarray(sm.u_right)
    ok = d > 0
    assert ok.sum() > 50, f"only {ok.sum()} stereo matches"
    med = np.median(d[ok])
    assert abs(med - depth_true) < 0.5, med
    # subpixel: disparity error under half a pixel for the matched majority
    errs = np.abs((np.asarray(fl.xy)[ok, 0] - ur[ok]) - disp_true)
    assert np.median(errs) < 0.5, np.median(errs)
