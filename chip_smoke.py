#!/usr/bin/env python
"""Smoke test of the stereo SLAM main path on one GPU, at full KITTI geometry.

    python chip_smoke.py               # one card, phases (a)-(f)
    python chip_smoke.py --trace DIR   # also trace a window of phase (e) into DIR
    python chip_smoke.py --four-cards  # four cards: sharded global BA + dry run only
    python chip_smoke.py --tiny        # CPU rehearsal at test size (never automatic)

One process holds the card for the whole run. Phases, in order:

  (a) device and card: JAX's platform, device kind and count, and the card's
      name and power limit from nvidia-smi. Exits non-zero without a GPU.
  (b) compile the tracker's 8-frame chunk program and the local-BA program at
      real widths and print their memory analysis; time the plain XLA FAST
      strength + NMS on a (16, 376, 1241) stack.
  (c) front end on the GPU against the CPU for one stereo pair of the bench
      world: pyramid, FAST, keypoints, descriptor bits, Hamming matrix.
  (d) one local-BA and one pose-optimization problem on the GPU against the CPU.
  (e) the 330-frame loopy bench world through SlamSystem.track_stereo_device,
      a warm lap then a timed lap: frames/s, compiles inside the timed lap, ATE,
      lost frames, loops closed, keyframes, peak device memory.
  (f) the last line of standard output is the JSON contract line.

Every gate that fails exits non-zero; no phase's failure is caught.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SYNC_EVERY = 8  # frames per tracker dispatch, as bench.py
TRACE_FRAMES = 48
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _check(failures: list, phase: str, name: str, value, limit, ok: bool) -> None:
    _log(phase, f"{name}: {value} (limit {limit}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{phase}:{name}")


def _configs(tiny: bool):
    """(SlamConfig, world factory, sync_every). Full: KITTI stereo defaults and
    the bench's 330-frame world at sync_every 8. Tiny: the system tests' 640x240
    config and their 270-frame loop world at their sync_every of 4, small enough
    for the CPU."""
    from slam_framework_tpu.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig

    if not tiny:
        import bench

        cfg = SlamConfig()
        return cfg, lambda: bench.make_bench_world(cfg.camera), SYNC_EVERY
    from slam_framework_tpu.io import synthetic

    cfg = SlamConfig(
        camera=CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640,
                            height=240, fps=10.0, bf=400.0 * 0.54),
        orb=OrbConfig(num_features=800, num_levels=4),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=65536,
                                max_features=1024, local_window_points=8192),
    )
    return cfg, lambda: synthetic.make_world(
        num_frames=270, cam=cfg.camera, seed=4, speed=1.0,
        yaw_rate=2.0 * np.pi / 200.0, num_landmarks=2500, corridor_half_width=7.0,
    ), 4


def _render(world, frames) -> list:
    """Stereo pairs (2, H, W) uint8 of `frames`, rendered on host threads."""
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        return [np.stack(p) for p in ex.map(world.stereo_pair, frames)]


def _ba_problem(cap, n_cams: int = 24, n_pts: int = 2600):
    """A KITTI-like local-BA problem at the mapper's slot widths
    (ba_cams, ba_points, ba_obs, ba_obs_per_point)."""
    from slam_framework_tpu.optim import local_ba
    from tools.bench_ba import make_problem

    g, K, _, _, _ = make_problem(n_cams, n_pts, obs_per_pt=6, seed=1)
    prob = local_ba.BAProblem(**{f: getattr(g, f) for f in local_ba.BAProblem._fields})
    widths = (prob.cam_pose.shape[0], prob.pt_pos.shape[0], prob.obs_cam.shape[0],
              prob.pt_obs_slots.shape[1])
    want = (cap.ba_cams, cap.ba_points, cap.ba_obs, cap.ba_obs_per_point)
    assert widths == want, f"BA problem widths {widths} != mapper slots {want}"
    return prob, K


def _centres(poses) -> np.ndarray:
    """Camera centres -R^T t of (..., 4, 4) Tcw poses."""
    T = np.asarray(poses, np.float64)
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


# ---------------------------------------------------------------------- phases


def phase_device(tiny: bool) -> dict:
    import jax

    from slam_framework_tpu.utils import device

    info = device.describe()
    _log("a", f"platform={info['platform']} device_kind={info['kind']} count={info['count']}")
    if not tiny:
        device.require_gpu()
    card = device.card_line() if not tiny else "none (CPU rehearsal)"
    _log("a", f"card: {card}")
    _log("a", f"jax {jax.__version__}")
    return {**info, "card": card}


def phase_compile(cfg, sync, pair0, ts0, tiny: bool):
    """Compile the chunk and local-BA programs; time plain-XLA FAST."""
    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.ops import fast
    from slam_framework_tpu.system import SlamSystem

    system = SlamSystem(cfg, sync_every=sync)
    system.track_stereo_device(jax.device_put(pair0), ts0)  # initializes the map
    tr = system.tracker
    assert tr._dstate is not None, "frame 0 did not initialize the map"
    spec = lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
    images = jax.ShapeDtypeStruct((sync,) + pair0.shape, jnp.uint8)
    t0 = time.perf_counter()
    chunk = tr._jit_chunk.lower(
        jax.tree.map(spec, tr._dstate), images, jax.tree.map(spec, tr._block)
    ).compile()
    _log("b", f"chunk program (sync_every={sync}, images {images.shape}) "
              f"compiled in {time.perf_counter() - t0:.1f} s")
    _log("b", f"chunk memory_analysis: {chunk.memory_analysis()}")
    prob, _ = _ba_problem(cfg.capacity)
    t0 = time.perf_counter()
    ba = tr.local_mapper._jit_ba.lower(jax.tree.map(spec, prob)).compile()
    _log("b", f"local-BA program (cams, points, obs) = {prob.cam_pose.shape[0]}, "
              f"{prob.pt_pos.shape[0]}, {prob.obs_cam.shape[0]} compiled in "
              f"{time.perf_counter() - t0:.1f} s")
    _log("b", f"local-BA memory_analysis: {ba.memory_analysis()}")
    system.shutdown()

    # plain XLA FAST-9 strength + 3x3 NMS over a stack of level-0 images
    shape = (16, cfg.camera.height, cfg.camera.width)
    x = jnp.floor(jax.random.uniform(jax.random.key(0), shape) * 256.0)
    f = jax.jit(jax.vmap(lambda im: fast.nms3x3(fast.fast_strength_map(im))))
    f(x).block_until_ready()
    if tiny:
        _log("b", f"fast_xla at {shape}: not measured (CPU rehearsal)")
        return chunk
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    _log("b", f"fast_xla at {shape}: median {np.median(times) * 1e3:.3f} ms, "
              f"min {min(times) * 1e3:.3f} ms over 20 calls")
    return chunk


def phase_frontend(cfg, pair, gpu, cpu) -> None:
    """Front end on `gpu` against the CPU reference for one stereo pair."""
    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.matching import hamming
    from slam_framework_tpu.ops import fast, pyramid
    from slam_framework_tpu.ops.extractor import OrbExtractor

    L, sf = cfg.orb.num_levels, cfg.orb.scale_factor
    ext = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)

    @jax.jit
    def pyr(img):
        f32 = img.astype(jnp.float32)
        return pyramid.build_pyramid(f32, L, sf), pyramid.build_blurred_pyramid(f32, L, sf)

    nms = jax.jit(lambda lv: [fast.nms3x3(fast.fast_strength_map(x)) for x in lv])
    extract = jax.jit(ext._extract_from_pyramid)
    failures: list = []
    descs = {}
    for side, img in (("left", pair[0]), ("right", pair[1])):
        lv_g, bl_g = pyr(jax.device_put(img, gpu))
        lv_c, bl_c = pyr(jax.device_put(img, cpu))
        d_pyr = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(lv_g + bl_g, lv_c + bl_c))
        _check(failures, "c", f"{side} pyramid+blur max abs diff (gray levels)",
               d_pyr, 1e-3, d_pyr <= 1e-3)
        # FAST on identical inputs: the CPU's levels, on both devices
        nms_g = nms(jax.device_put(lv_c, gpu))
        nms_c = nms(lv_c)
        n_diff = sum(int((np.asarray(a) != np.asarray(b)).sum()) for a, b in zip(nms_g, nms_c))
        n_corners = sum(int((np.asarray(b) > 0).sum()) for b in nms_c)
        _check(failures, "c", f"{side} NMS'd FAST maps: differing pixels "
               f"(of {n_corners} corners)", n_diff, 0, n_diff == 0)
        fg = jax.device_get(extract(lv_g, bl_g))
        fc = jax.device_get(extract(lv_c, bl_c))
        key = lambda f, i: (float(f.xy[i, 0]), float(f.xy[i, 1]), int(f.octave[i]))
        cpu_idx = {key(fc, i): i for i in np.nonzero(fc.valid)[0]}
        pairs = [(i, cpu_idx[key(fg, i)]) for i in np.nonzero(fg.valid)[0]
                 if key(fg, i) in cpu_idx]
        same = len(pairs) / max(len(cpu_idx), 1)
        _check(failures, "c", f"{side} keypoints identical ({len(pairs)}/{len(cpu_idx)})",
               f"{same:.4%}", ">= 99%", same >= 0.99)
        gi, ci = np.asarray(pairs).T
        bits_g = np.unpackbits(fg.desc[gi].view(np.uint8), axis=1)
        bits_c = np.unpackbits(fc.desc[ci].view(np.uint8), axis=1)
        eq = float((bits_g == bits_c).mean())
        _check(failures, "c", f"{side} descriptor bits equal on identical keypoints",
               f"{eq:.5%}", ">= 99.5%", eq >= 0.995)
        descs[side] = fc.desc
    ham = jax.jit(hamming.hamming_matrix)
    h_g = np.asarray(ham(jax.device_put(descs["left"], gpu), jax.device_put(descs["right"], gpu)))
    h_c = np.asarray(ham(jax.device_put(descs["left"], cpu), jax.device_put(descs["right"], cpu)))
    n_diff = int((h_g != h_c).sum())
    _check(failures, "c", f"hamming_matrix {h_c.shape} differing entries", n_diff, 0, n_diff == 0)
    if failures:
        raise SystemExit(f"phase (c) failed: {failures}")


def phase_solvers(cfg, gpu, cpu) -> None:
    """One local BA and one pose optimization on `gpu` against the CPU."""
    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.geometry import se3
    from slam_framework_tpu.optim import local_ba, pose_opt

    failures: list = []
    prob, K = _ba_problem(cfg.capacity)
    ba = jax.jit(functools.partial(
        local_ba.optimize, K=K, iters_first=cfg.mapping.local_ba_iters_first,
        iters_second=cfg.mapping.local_ba_iters_second,
    ))
    res_g = ba(jax.device_put(prob, gpu))
    res_c = ba(jax.device_put(prob, cpu))
    live = np.asarray(prob.cam_mask)
    d_ba = float(np.abs(_centres(res_g.cam_pose) - _centres(res_c.cam_pose))[live].max())
    _check(failures, "d", f"local BA camera centres, GPU vs CPU, max abs diff (m) "
           f"[chi2 {float(res_g.total_chi2):.6g} vs {float(res_c.total_chi2):.6g}]",
           d_ba, 1e-3, d_ba <= 1e-3)

    rng = np.random.default_rng(2)
    n = cfg.capacity.max_features
    pts = np.stack([rng.uniform(-15, 15, n), rng.uniform(-4, 4, n),
                    rng.uniform(4, 50, n)], -1).astype(np.float32)
    T_true = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.05, jnp.float32)))
    Xc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    u = K.fx * Xc[:, 0] / Xc[:, 2] + K.cx + rng.normal(0, 0.5, n)
    v = K.fy * Xc[:, 1] / Xc[:, 2] + K.cy + rng.normal(0, 0.5, n)
    obs = pose_opt.PoseObs(
        points_w=jnp.asarray(pts), uv=jnp.asarray(np.stack([u, v], -1), jnp.float32),
        ur=jnp.asarray(u - K.bf / Xc[:, 2], jnp.float32),
        inv_sigma2=jnp.ones(n, jnp.float32), mask=jnp.ones(n, bool),
    )
    T0 = np.asarray(se3.se3_exp(jnp.asarray([0.01, -0.02, 0.01, 0.2, -0.1, 0.3], jnp.float32)))
    T0 = jnp.asarray(T0 @ T_true)
    po = jax.jit(functools.partial(pose_opt.optimize_pose, K=K, n_rounds=3, n_iters=4))
    p_g = po(jax.device_put(T0, gpu), jax.device_put(obs, gpu)).pose
    p_c = po(jax.device_put(T0, cpu), jax.device_put(obs, cpu)).pose
    d_po = float(np.abs(_centres(p_g) - _centres(p_c)).max())
    _check(failures, "d", "pose_opt camera centre, GPU vs CPU, max abs diff (m)",
           d_po, 1e-3, d_po <= 1e-3)
    if failures:
        raise SystemExit(f"phase (d) failed: {failures}")


def _lap(cfg, sync, pairs, timestamps):
    """One pass of SlamSystem over the staged pairs: (system, stats, wall s).
    The wall clock ends after the tail flush, whose last step is a host fetch."""
    from slam_framework_tpu.system import SlamSystem

    system = SlamSystem(cfg, sync_every=sync)
    t0 = time.perf_counter()
    for f, pair in enumerate(pairs):
        system.track_stereo_device(pair, timestamps[f])
    system.tracker.flush()
    wall = time.perf_counter() - t0
    return system, system.shutdown(), wall


def phase_end_to_end(cfg, sync, world, pairs, dev, card: str, counts, trace_dir,
                     chunk) -> None:
    import jax

    from slam_framework_tpu.io import trajectory

    n = len(pairs)
    staged = [jax.device_put(p, dev) for p in pairs]
    jax.block_until_ready(staged)
    _, _, warm_wall = _lap(cfg, sync, staged, world.timestamps)
    _log("e", f"warm lap: {n} frames in {warm_wall:.2f} s (compiles included)")
    before = counts[COMPILE_EVENT]
    system, stats, wall = _lap(cfg, sync, staged, world.timestamps)
    compiles = counts[COMPILE_EVENT] - before
    est = system.frame_poses()
    ate = float(trajectory.ate_rmse(est, world.poses[: len(est)], align="se3"))
    lost = sum(1 for r in system.tracker.records if r.lost)
    loops = stats.get("loops_closed", 0)
    mem = dev.memory_stats() or {}
    _log("e", f"timed lap: {n} frames in {wall:.3f} s = {n / wall:.3f} frames/s")
    _log("e", f"compiles inside the timed lap: {compiles}")
    _log("e", f"ATE {ate:.4f} m, lost frames {lost}, loops closed {loops}, "
              f"keyframes {stats.get('keyframes', 0)}")
    _log("e", f"peak_bytes_in_use: {mem.get('peak_bytes_in_use', 'not reported')}")
    _log("e", f"card: {card}")
    _log("e", f"stage timers (ms): {json.dumps(system.tracker.timers.summary())}")
    failures: list = []
    _check(failures, "e", "lost frames", lost, "== 0", lost == 0)
    _check(failures, "e", "loops closed", loops, ">= 1", loops >= 1)
    _check(failures, "e", "ATE (m)", f"{ate:.4f}", "< 1.0", ate < 1.0)
    if failures:
        raise SystemExit(f"phase (e) failed: {failures}")
    if trace_dir:
        _trace_window(cfg, sync, staged[:TRACE_FRAMES], world.timestamps, trace_dir, chunk)


def _trace_window(cfg, sync, staged, timestamps, trace_dir: str, chunk) -> None:
    """Profile a fresh system over the first frames and report FAST's share of
    the chunk program's device time (kernels whose HLO ops sit under the
    extractor's `fast` named scope)."""
    import jax

    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "chunk_hlo.txt"), "w") as fh:
        fh.write(chunk.as_text())
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0  # device kernels and annotated host spans only
    opts.host_tracer_level = 1
    with jax.profiler.trace(trace_dir, profiler_options=opts):
        _lap(cfg, sync, staged, timestamps)
    share = fast_share(trace_dir, chunk.as_text())
    _log("e", f"trace of {len(staged)} frames in {trace_dir}: {json.dumps(share)}")


def fast_share(trace_dir: str, hlo_text: str) -> dict:
    """Device time of the chunk program and of its FAST kernels in the newest
    trace under `trace_dir`."""
    import glob
    import re

    import jax

    fast_ops = set()
    scope = re.compile(r'op_name="(?:[^"]*/)?fast(?:/[^"]*)?"')
    comp_of, comp_ops, current = {}, collections.defaultdict(list), None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$", line)
        if not m:
            h = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+).*\{\s*$", line)
            if h:
                current = h.group(1)
            continue
        name, rest = m.groups()
        in_scope = bool(scope.search(rest))
        comp_ops[current].append(in_scope)
        if in_scope:
            fast_ops.add(name)
        c = re.search(r"calls=%?([\w.\-]+)", rest)
        if c:
            comp_of[name] = c.group(1)
    # a fusion counts as FAST when most of the ops it fuses are
    for name, comp in comp_of.items():
        flags = comp_ops.get(comp, [])
        if flags and sum(flags) * 2 > len(flags):
            fast_ops.add(name)

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    # XLA:GPU runs programs as CUDA graphs: a kernel event's hlo_op is then
    # "command_buffer" and its name is the fusion's name with '.'/'-' -> '_'
    kernel = lambda op: op.replace(".", "_").replace("-", "_")
    fast_kernels = {kernel(op) for op in fast_ops}
    total = fast_ns = 0
    per_op: collections.Counter = collections.Counter()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                module = str(stats.get("hlo_module", ""))
                op = str(stats.get("hlo_op", ev.name))
                op = ev.name if op == "command_buffer" else op
                per_op[f"{module}:{op}"] += ev.duration_ns
                if "_chunk" not in module:
                    continue
                total += ev.duration_ns
                if kernel(op) in fast_kernels:
                    fast_ns += ev.duration_ns
    with open(os.path.join(trace_dir, "kernels.json"), "w") as fh:
        json.dump(dict(per_op.most_common(400)), fh, indent=0)
    return {"chunk_device_ms": total / 1e6, "fast_device_ms": fast_ns / 1e6,
            "fast_share": fast_ns / total if total else None,
            "fast_hlo_ops": len(fast_ops), "trace": path}


# ---------------------------------------------------------------------- four cards


def four_cards(tiny: bool) -> dict:
    """Sharded post-loop global BA over four cards against one card, the
    multi-device dry run, and the mapper placed on card 1. `tiny` rehearses it
    on four virtual CPU devices with a 64-KF problem."""
    import jax
    from jax.sharding import Mesh

    from slam_framework_tpu.optim import global_ba
    from slam_framework_tpu.parallel import dist_ba
    from slam_framework_tpu.utils import device
    from tools.bench_ba import make_problem

    info = device.describe() if tiny else device.require_gpu()
    if info["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {info['count']}")
    devs = jax.devices()[:4]
    _log("4", f"platform={info['platform']} device_kind={info['kind']} count={info['count']}")
    _log("4", f"card: {'none (CPU rehearsal)' if tiny else device.card_line()}")

    n_kfs, n_pts = (64, 8192) if tiny else (500, 100_000)
    prob, K, _, _, m = make_problem(n_kfs, n_pts, 6)
    _log("4", f"global BA problem: {n_kfs} KFs, {n_pts} points, {m} observations")
    iters = dict(iters_first=5, iters_second=10, cg_iters=40)
    mesh = Mesh(np.array(devs), ("ba",))
    prob_one, sharded = jax.device_put(prob, devs[0]), dist_ba.shard_problem(prob, 4)
    runs = {
        "one card": lambda: global_ba.optimize_global(prob_one, K=K, **iters),
        "four cards": lambda: dist_ba.optimize_global_sharded(sharded, mesh, K, **iters),
    }
    res = {}
    for name, run in runs.items():
        walls = []
        for _ in range(2):  # the first call compiles
            t0 = time.perf_counter()
            res[name] = run()
            jax.block_until_ready(res[name].cam_pose)
            walls.append(time.perf_counter() - t0)
        _log("4", f"{name}: {walls[0]:.2f} s with compile, {walls[1]:.3f} s warm "
                  f"(15 LM iterations)")
    one, four = res["one card"], res["four cards"]
    d = float(np.abs(_centres(one.cam_pose) - _centres(four.cam_pose))[:n_kfs].max())
    _log("4", f"camera centres, 4 cards vs 1, max abs diff (m): {d} (limit 1e-3) "
              f"{'ok' if d <= 1e-3 else 'FAIL'}")
    if d > 1e-3:
        raise SystemExit("four-card global BA disagrees with one card")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)

    cfg, make_world, sync = _configs(tiny=True)
    world = make_world()
    pairs = _render(world, range(60))
    system, stats, wall = _lap(
        cfg, sync, [jax.device_put(p, devs[0]) for p in pairs], world.timestamps
    )
    mapper_dev = system.tracker.local_mapper.device
    lost = sum(1 for r in system.tracker.records if r.lost)
    _log("4", f"mapper on {mapper_dev}: 60 frames in {wall:.1f} s, keyframes "
              f"{stats['keyframes']}, lost {lost}")
    if mapper_dev != devs[1] or lost:
        raise SystemExit("mapper on card 1 failed")
    return info


# ---------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal at the system tests' size (no GPU needed)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and what it is compared with")
    ap.add_argument("--trace", metavar="DIR",
                    help="trace a window of phase (e) and report FAST's share")
    args = ap.parse_args(argv)

    if args.tiny and args.four_cards:
        # four virtual CPU devices; must precede the CPU client's start
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
        ).strip()
    import jax

    # compiles (or persistent-cache loads) and persistent-cache hits/misses
    counts: collections.Counter = collections.Counter()
    jax.monitoring.register_event_listener(lambda event, **_: counts.update([event]))
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **_: counts.update([event])
    )

    if args.four_cards:
        info = four_cards(args.tiny)
    else:
        info = phase_device(args.tiny)
        cfg, make_world, sync = _configs(args.tiny)
        dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
        t0 = time.perf_counter()
        world = make_world()
        pairs = _render(world, range(world.num_frames))
        _log("e", f"rendered {len(pairs)} pairs of {pairs[0].shape} in "
                  f"{time.perf_counter() - t0:.1f} s (set-up)")
        chunk = phase_compile(cfg, sync, pairs[0], world.timestamps[0], args.tiny)
        phase_frontend(cfg, pairs[0], dev, cpu)
        phase_solvers(cfg, dev, cpu)
        phase_end_to_end(cfg, sync, world, pairs, dev, info["card"], counts, args.trace,
                         chunk)
    _log("f", "persistent compile cache: dir="
              f"{jax.config.jax_compilation_cache_dir} hits="
              f"{counts['/jax/compilation_cache/cache_hits']} misses="
              f"{counts['/jax/compilation_cache/cache_misses']}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"], "count": info["count"],
    }}))
    return 0


if __name__ == "__main__":
    # the CPU reference of phases (c)/(d) needs the CPU backend beside the GPU
    _platforms = os.environ.get("JAX_PLATFORMS")
    if _platforms and "cpu" not in _platforms.split(","):
        os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"
    sys.exit(main())
