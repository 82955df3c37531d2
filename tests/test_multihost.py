"""Multi-process (multi-host) distributed-optimizer validation.

Reference parity target: the reference has no distributed backend at all
(SURVEY.md §2.3 row 4 — its fabric is in-process mutexes); SURVEY §5.8 mandates
one here. This drives tools/multihost_demo.py: N real OS processes linked by
jax.distributed (the same runtime layout as N accelerator hosts, the network replaced by
localhost TCP), each running the shard_map programs of parallel/dist_ba.py and
parallel/dist_pose_graph.py over the GLOBAL mesh, checked against the
single-device optimizers."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_dist_ba_and_pose_graph_match_single_device():
    env = dict(os.environ)
    # the spawned workers configure their own XLA_FLAGS / platform
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_demo.py"),
         "--processes", "2", "--local-devices", "2", "--port", "19877"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    res = json.loads(line)
    assert res["global_devices"] == 4
    assert res["ok"], res
    assert res["ba_cam_max_err_m"] < 1e-3
    assert res["pg_vt_max_err_m"] < 1e-3
    # map-block sharding (SURVEY §5.8): segment-owned BA parity + the
    # cross-process all_to_all point migration (verified inside each worker)
    assert res["segba_cam_max_err_m"] < 1e-3
    assert res["migrate_ok"]
