"""Per-component profile of an adaptive tick (VERDICT r4 next #8).

Grids-class adaptive runs have an EMPTY aux group (every candidate is
dense-eligible with tiny blankets, so no split execution), yet r4
acceptance shows adaptive at 5.6e8 samples/s vs plain 3.8e9 — a 6.7x
gap that must be main-path overhead.  This tool runs the adaptive
engine loop shape by hand and wall-times each component:

    python -m grample_tpu.tools.profile_adaptive --net Grids_13 --secs 60
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from grample_tpu.sampler.adaptive import adapt_step
from grample_tpu.sampler.chains import ChainGroup
from grample_tpu.uai import load_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get(
        "GRAMPLE_RES", "/root/reference/res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--secs", type=float, default=60.0)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--cw", type=int, default=2000)
    ap.add_argument("--nwin", type=int, default=4,
                    help="windows per tick (the engine batches ~status_secs)")
    ap.add_argument("--adds", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    path = os.path.join(args.res, args.net + ".uai")
    m = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    g = ChainGroup(m, chains_per_variant=args.chains, converge_window=args.cw,
                   seed=1, collapse_headroom=True)
    g.reserve(g.max_variants)  # the engine's auto-reserve (small nets)
    g.add_variant(m)
    g.add_variant(m)
    g.warmup()
    g.burn_annealed(2000)

    t = {k: 0.0 for k in ("advance", "flush", "rb", "merged", "adapt")}
    n_ticks = 0
    t_end = time.time() + args.secs
    t_loop0 = time.time()
    while time.time() < t_end:
        t0 = time.time()
        for _ in range(args.nwin):
            g.advance(args.cw, defer=True)
        t["advance"] += time.time() - t0
        t0 = time.time()
        g.flush()
        t["flush"] += time.time() - t0
        t0 = time.time()
        g.rb_accumulate()
        t["rb"] += time.time() - t0
        t0 = time.time()
        g.merged_marginals()
        t["merged"] += time.time() - t0
        t0 = time.time()
        if g.num_variants < g.max_variants:
            adapt_step(g, args.adds)
        t["adapt"] += time.time() - t0
        n_ticks += 1
    t["other"] = (time.time() - t_loop0) - sum(t.values())

    total = sum(t.values())
    out = {
        "net": args.net,
        "ticks": n_ticks,
        "variants": g.num_variants,
        "chains": g.num_chains,
        "samples": g.total_samples,
        "samples_per_sec": round(g.total_samples / max(total, 1e-9), 1),
        **{f"secs_{k}": round(v, 2) for k, v in t.items()},
        **{f"share_{k}": round(v / max(total, 1e-9), 4) for k, v in t.items()},
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
