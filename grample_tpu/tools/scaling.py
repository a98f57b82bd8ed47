"""Virtual-mesh scaling measurement (BASELINE.md scaling report stand-in).

This measures the sharded chain runtime's scaling on an
N-virtual-device CPU mesh (``xla_force_host_platform_device_count``):
WEAK scaling — per-device chain count held constant — of the sweep
(communication-free under shard_map) and the per-tick reduction surface
(merged marginals + PSRF, which ride psum collectives).

    python -m grample_tpu.tools.scaling --net Grids_13 --out results/scaling.jsonl

Emits one JSON line per (net, n_devices) from subprocesses (the device
count must be fixed before jax import).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def measure(net: str, res_dir: str, n_dev: int, cpv_per_dev: int,
            cw: int, windows: int) -> dict:
    import numpy as np  # noqa: F401

    import jax

    from grample_tpu.parallel.mesh import ShardedChainGroup, chain_mesh
    from grample_tpu.uai import load_model

    assert len(jax.devices()) >= n_dev, (len(jax.devices()), n_dev)
    path = os.path.join(res_dir, net + ".uai")
    m = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    mesh = chain_mesh(n_devices=n_dev, variant_ways=1)
    g = ShardedChainGroup(
        m, chains_per_variant=cpv_per_dev * n_dev, converge_window=cw,
        seed=1, mesh=mesh,
    )
    g.add_variant(m)
    g.add_variant(m)
    g.warmup()
    g.burn(16)
    # sweep timing: windows dispatched with deferred deltas, one sync
    t0 = time.time()
    for _ in range(windows):
        g.advance(cw, defer=True)
    g.flush()
    sweep_secs = time.time() - t0
    samples = g.total_samples
    # reduction surface: merge + PSRF at scoring cadence
    t1 = time.time()
    reps = 3
    for _ in range(reps):
        merged = g.merged_marginals()
        g.convergence(merged=merged)
    red_secs = (time.time() - t1) / reps
    return {
        "net": net,
        "devices": n_dev,
        "chains": g.num_chains,
        "chains_per_device": cpv_per_dev * g.num_variants,
        "windows": windows,
        "cw": cw,
        "samples": samples,
        "sweep_secs": round(sweep_secs, 3),
        "samples_per_sec": round(samples / sweep_secs, 1),
        "reduction_secs_per_tick": round(red_secs, 4),
        "reduction_share_per_tick": round(
            red_secs / (sweep_secs / windows + red_secs), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get(
        "GRAMPLE_RES", "/root/reference/res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--devices", type=int, default=0,
                    help="internal: measure at this count (else drive all)")
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--cpv", type=int, default=256,
                    help="micro-chains per variant per device (weak scaling)")
    ap.add_argument("--cw", type=int, default=64)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.devices:
        r = measure(args.net, args.res, args.devices, args.cpv, args.cw,
                    args.windows)
        print("SCALING-RESULT:" + json.dumps(r), flush=True)
        return 0

    rows = []
    for n in [int(x) for x in args.counts.split(",")]:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        ).strip()
        cmd = [sys.executable, "-m", "grample_tpu.tools.scaling",
               "--res", args.res, "--net", args.net, "--devices", str(n),
               "--cpv", str(args.cpv), "--cw", str(args.cw),
               "--windows", str(args.windows)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=3600, env=env,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.dirname(os.path.abspath(__file__)))))
        row = None
        for line in proc.stdout.splitlines():
            if line.startswith("SCALING-RESULT:"):
                row = json.loads(line[len("SCALING-RESULT:"):])
        if row is None:
            err = (proc.stderr or "").strip().splitlines()
            row = {"net": args.net, "devices": n,
                   "error": err[-1][:200] if err else f"exit {proc.returncode}"}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
