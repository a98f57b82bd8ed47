#!/usr/bin/env python3
"""On-chip smoke test: the Gibbs engine's main path on one NVIDIA GPU.

Run from the root of a checkout, where it is the only process on the card:

    python3 chip_smoke.py                 # one card, phases 0-4
    python3 chip_smoke.py --cards 4       # four cards: the sharded path only

Everything is generated from ``--seed`` inside the checkout; nothing is
read from outside it.  Generated nets and traces go to ``--out``
(default ``smoke_out/``, git-ignored).

Phases (one card):

0. Device: a GPU is required — there is no CPU fallback.  Prints the
   device, the jax version, ``XLA_FLAGS``, the compile-cache directory
   and the card's name and power limit from ``nvidia-smi``.
1. Generated net: a binary 10x10 Ising grid (the Grids_13 shape: 100
   unary and 180 pairwise factors, pairwise log-potentials in +-10,
   10 evidence variables) and its exact marginals from a float64
   log-space row transfer matrix that shares no code with the encoder.
2. Sweep logits vs reference at full width: ``ops.gibbs_xla._color_logits``
   on the card in each sweep mode the encoder can choose, against a
   numpy float64 evaluation of every incident factor over all chains.
3. Sampler vs exact at full width: a plain ``ChainGroup`` on the same
   grid at couplings of +-0.5 (where Gibbs mixes), checked against the
   transfer-matrix marginals within a 5-sigma bound; sweep rates at two
   widths and a profiler trace of one counted window.
4. End to end through the CLI: ``simple``, ``adaptive`` and
   ``collapsed`` runs on the strong-coupling net, scored against its
   exact marginals.

``--cards 4`` runs phase 3's statistical check under a
``ShardedChainGroup`` over ``chain_mesh(4)`` and phase 4's adaptive run
with ``--mesh auto``, and nothing else.

Any failure raises and exits non-zero.  The last line of standard
output is one JSON object: ``{"ok": true, "device": {...}}``.  Rates
printed here are a smoke check, not a benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from grample_tpu.pgm.discrete import LOG_EPS, DiscreteModel, Factor

#: full chain width: the width of the throughput measurements this
#: engine is run at
CHAINS = 262144

#: the grid side of the Grids_13 shape (SURVEY.md §6)
SIDE = 10

#: max abs error allowed between the card's sweep logits and the float64
#: reference.  float32 under precision=HIGHEST keeps ~1e-5 on logits of
#: magnitude ~40; a TF32 product would miss by about two orders.
LOGITS_TOL = 1e-4

#: published HBM bandwidth by device kind (NVIDIA H100 SXM data sheet),
#: used only for the bandwidth share of the traced sweep
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100": 3.35e12}

SWEEP_MODES = ("matmul", "rowgather", "gather")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0
def require_gpu():
    """The visible devices, which must be GPUs; raises otherwise."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found platform {devs[0].platform!r}"
        )
    return devs


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 1
def grid_net(side: int = SIDE, coupling: float = 10.0, field: float = 1.0,
             n_evidence: int = 10, seed: int = 0):
    """A binary side x side Ising grid and an evidence assignment.

    Unary log-potentials (h, -h) with h uniform in +-``field``; pairwise
    (w, -w, -w, w) with w uniform in +-``coupling``.  Returns the model
    (evidence not applied) and ``{var: value}``.
    """
    rng = np.random.default_rng(seed)
    v = side * side
    factors = []
    for i in range(v):
        h = rng.uniform(-field, field)
        factors.append(Factor(f"u{i}", [i], np.exp([h, -h])))
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for j in ([i + 1] if c + 1 < side else []) + (
                [i + side] if r + 1 < side else []
            ):
                w = rng.uniform(-coupling, coupling)
                factors.append(Factor(f"p{i}_{j}", [i, j], np.exp([w, -w, -w, w])))
    model = DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors,
                          name=f"grid{side}")
    ev = rng.choice(v, size=n_evidence, replace=False)
    evidence = {int(u): int(rng.integers(2)) for u in sorted(ev)}
    return model, evidence


def _logsumexp(x, axis):
    mx = np.max(x, axis=axis, keepdims=True)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    return np.squeeze(mx, axis=axis) + np.log(np.sum(np.exp(x - mx), axis=axis))


def grid_exact(model: DiscreteModel, side: int) -> np.ndarray:
    """Exact [V, 2] marginals of a binary pairwise side x side grid.

    Row transfer matrices over the 2^side states of a grid row, in
    float64 log space; evidence (``model.fixed``) clamps row states.
    Tables get the same 1e-6 log floor the samplers see.
    """
    if np.any(model.cards != 2) or model.num_vars != side * side:
        raise ValueError("grid_exact needs a binary side x side grid")
    n = 1 << side
    bits = (np.arange(n)[:, None] >> np.arange(side)[None, :]) & 1  # [n, side]
    row_lp = np.zeros((side, n))
    trans = np.zeros((max(side - 1, 0), n, n))
    for f in model.factors:
        t = f.table if f.is_log else np.log(np.where(f.table < LOG_EPS, f.table + LOG_EPS, f.table))
        rows, cols = f.scope // side, f.scope % side
        if f.scope.size == 1:
            row_lp[rows[0]] += t[bits[:, cols[0]]]
        elif f.scope.size == 2 and rows[0] == rows[1] and abs(cols[0] - cols[1]) == 1:
            row_lp[rows[0]] += t[2 * bits[:, cols[0]] + bits[:, cols[1]]]
        elif f.scope.size == 2 and cols[0] == cols[1] and rows[1] == rows[0] + 1:
            trans[rows[0]] += t[2 * bits[:, cols[0]][:, None] + bits[:, cols[1]][None, :]]
        elif f.scope.size == 2 and cols[0] == cols[1] and rows[0] == rows[1] + 1:
            trans[rows[1]] += t[2 * bits[:, cols[0]][None, :] + bits[:, cols[1]][:, None]]
        else:
            raise ValueError(f"factor {f.name} is not a grid factor")
    for u in np.nonzero(model.fixed >= 0)[0]:
        r, c = divmod(int(u), side)
        row_lp[r][bits[:, c] != model.fixed[u]] = -np.inf
    alpha = np.zeros((side, n))
    alpha[0] = row_lp[0]
    for r in range(1, side):
        alpha[r] = row_lp[r] + _logsumexp(alpha[r - 1][:, None] + trans[r - 1], axis=0)
    beta = np.zeros((side, n))
    for r in range(side - 2, -1, -1):
        beta[r] = _logsumexp(trans[r] + (row_lp[r + 1] + beta[r + 1])[None, :], axis=1)
    out = np.zeros((side * side, 2))
    for r in range(side):
        lp = alpha[r] + beta[r]
        p = np.exp(lp - lp.max())
        p /= p.sum()
        # [side]: P(column c of row r is 1), and of 0 (never 1 - p1,
        # which can round below zero)
        out[r * side: (r + 1) * side, 1] = p @ bits
        out[r * side: (r + 1) * side, 0] = p @ (1 - bits)
    return out


def write_net(out_dir: str, name: str, model: DiscreteModel, evidence: dict,
              exact: np.ndarray) -> str:
    """``<name>.uai`` with ``.evid`` and ``.MAR`` beside it; returns the path."""
    from grample_tpu.uai.writer import write_evidence, write_mar, write_model

    path = os.path.join(out_dir, name + ".uai")
    with open(path, "w") as fh:
        fh.write(write_model(model))
    with open(path + ".evid", "w") as fh:
        fh.write(write_evidence(evidence))
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([exact[i] for i in range(model.num_vars)]))
    return path


def with_evidence(model: DiscreteModel, evidence: dict) -> DiscreteModel:
    m = DiscreteModel(type=model.type, cards=model.cards.copy(),
                      factors=[f.clone() for f in model.factors], name=model.name)
    m.apply_evidence(evidence)
    return m


# ---------------------------------------------------------------- phase 2
def mode_caps(model: DiscreteModel, mode: str):
    """Encode caps forcing one sweep mode (``matmul``, ``rowgather`` or
    ``gather``), as the encoder would select it."""
    from grample_tpu.pgm.encode import compute_caps

    caps = compute_caps(model)
    if mode == "matmul":
        return caps
    if mode == "rowgather":
        return dataclasses.replace(caps, base_mode="rowgather")
    if mode == "gather":
        return dataclasses.replace(
            caps, base_mode="gather", adj_cap=0, oa_cap=1,
            gfac_cap=caps.adj_cap + caps.gfac_cap,
        )
    raise ValueError(f"unknown sweep mode {mode!r}")


def random_state(model: DiscreteModel, chains: int, seed: int) -> np.ndarray:
    """[C, V+1] int32 random chain states, evidence pinned, sentinel 0."""
    rng = np.random.default_rng(seed)
    v = model.num_vars
    st = np.zeros((chains, v + 1), dtype=np.int32)
    st[:, :v] = (rng.random((chains, v)) * model.cards[None, :]).astype(np.int32)
    fixed = model.fixed >= 0
    st[:, :v][:, fixed] = model.fixed[fixed]
    return st


def reference_logits(model: DiscreteModel, state: np.ndarray) -> np.ndarray:
    """[V, K, C] float64 log-conditionals: each incident factor's
    (floored) log-table evaluated directly, vectorized over chains."""
    c = state.shape[0]
    out = np.zeros((model.num_vars, int(model.cards.max()), c))
    for f in model.factors:
        t = f.table if f.is_log else np.log(np.where(f.table < LOG_EPS, f.table + LOG_EPS, f.table))
        strides = f.strides(model.cards)
        vals = state[:, f.scope].astype(np.int64)  # [C, S]
        full = vals @ strides
        for p, u in enumerate(f.scope):
            base = full - vals[:, p] * strides[p]
            for k in range(int(model.cards[u])):
                out[u, k] += t[base + k * strides[p]]
    return out


def sweep_logits(model: DiscreteModel, caps, state: np.ndarray):
    """The device sweep's log-conditionals for every colour group.

    Returns (vars [n], logits [n, K, C] float32) for the valid group
    slots, computed by ``gibbs_xla._color_logits`` on the default device.
    """
    from grample_tpu.ops.gibbs_xla import _XS_KEYS, _color_logits
    from grample_tpu.pgm.encode import encode_model

    enc = encode_model(model, caps)
    state_p = jnp.asarray(state.T[enc.old_of_new].astype(np.float32))
    tables = jnp.asarray(enc.tables)
    fn = jax.jit(_color_logits)
    var_ids, outs = [], []
    for ci in range(enc.num_colors):
        xs = tuple(jnp.asarray(getattr(enc, k)[ci]) for k in _XS_KEYS)
        wb = None if enc.sw_wbase is None else jnp.asarray(enc.sw_wbase[ci])
        lg = np.asarray(fn(state_p, tables, xs, wb))  # [G, K, C]
        ok = enc.color_mask[ci]
        var_ids.append(enc.color_vars[ci][ok])
        outs.append(lg[ok])
    return np.concatenate(var_ids), np.concatenate(outs)


def logits_max_error(model: DiscreteModel, mode: str, state: np.ndarray,
                     ref: np.ndarray = None) -> float:
    """Max abs error of the device sweep's logits in ``mode`` against
    :func:`reference_logits` over every free var, value and chain."""
    if ref is None:
        ref = reference_logits(model, state)
    vs, got = sweep_logits(model, mode_caps(model, mode), state)
    err = 0.0
    for i, u in enumerate(vs):
        k = int(model.cards[u])
        err = max(err, float(np.max(np.abs(got[i, :k] - ref[u, :k]))))
    return err


def print_memory_analysis(model: DiscreteModel, chains: int) -> None:
    """``compiled.memory_analysis()`` of one counted ``advance_chains``."""
    from grample_tpu.ops.gibbs_xla import advance_chains
    from grample_tpu.pgm.encode import encode_model, stack_variants

    enc = encode_model(model)
    stack = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in stack_variants([enc]).items()}
    v1, k = enc.caps.num_vars + 1, enc.caps.max_card
    state = jax.ShapeDtypeStruct((1, chains, v1), jnp.int32)
    halves = jax.ShapeDtypeStruct((1, 2, chains, v1, k), jnp.float32)
    key = jax.random.key(0, impl="rbg")
    ma = advance_chains.lower(stack, state, halves, key, 1, 0, count=True).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    log("  advance_chains memory_analysis @ %d chains: %s" % (
        chains, json.dumps({f: getattr(ma, f, None) for f in fields})))


# ---------------------------------------------------------------- phase 3
def busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals (ns)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return int(total)


def sweep_bytes(caps, chains: int) -> dict:
    """Bytes one sweep moves if each tensor is touched once, from shapes.

    State [NVp, C] f32 read and written; the counted half's
    [NC*G, K, C] f32 block read and written; the dense bank's one-hot
    [NC, G, F, OA, C] f32 written and read (zero if XLA fuses it away)."""
    st = 2 * caps.num_rows * chains * 4
    cnt = 2 * caps.num_slots * caps.max_card * chains * 4
    oh = 2 * caps.num_slots * caps.adj_cap * caps.oa_cap * chains * 4
    return {"state": st, "counts": cnt, "onehot": oh, "total": st + cnt + oh}


def trace_window(group, sweeps: int, trace_dir: str) -> dict:
    """Profile one counted window: device busy time is the union of the
    GPU planes' stream events, the device span runs from the first to the
    last of them, and the wall time is the host clock around the window
    (tracing on, so it runs long)."""
    from jax.profiler import ProfileData

    group.advance(sweeps)  # settle: same shapes, already compiled
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        group.advance(sweeps)  # flushes: ends in a host sync
        wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = ProfileData.from_file(paths[-1])
    layout, busy, n_kernels = [], 0, 0
    window = None
    for plane in pd.planes:
        lines = list(plane.lines)
        layout.append({"plane": plane.name,
                       "lines": [[ln.name, len(list(ln.events))] for ln in lines]})
        if not plane.name.startswith("/device:GPU"):
            continue
        iv = []
        for ln in lines:
            if ln.name.startswith("XLA") or "Stream" not in ln.name:
                continue
            for ev in ln.events:
                iv.append((int(ev.start_ns), int(ev.start_ns + ev.duration_ns)))
        n_kernels += len(iv)
        busy += busy_ns(iv)
        if iv:
            lo, hi = min(s for s, _ in iv), max(e for _, e in iv)
            window = (lo, hi) if window is None else (min(window[0], lo), max(window[1], hi))
    with open(os.path.join(trace_dir, "layout.json"), "w") as fh:
        json.dump(layout, fh, indent=1)
    span = 0 if window is None else window[1] - window[0]
    return {"sweeps": sweeps, "wall_s": wall, "busy_ns": busy,
            "kernel_span_ns": span, "kernels": n_kernels}


def sampler_check(model, exact, chains, burn, windows, window, seed,
                  mesh=None, n_slots=1):
    """Burn in, take counted windows, compare merged marginals to exact.

    Returns (group, max_abs_err, bound, elapsed seconds of the windows).
    The bound is 5 sigma of a per-var mean over independent chains
    (each chain's time-average varies no more than one draw,
    p(1-p) <= 1/4), plus the merge's uniform prior of one pseudo-draw
    per chain against ``windows * window`` counted sweeps."""
    from grample_tpu.pgm.discrete import norm_marginals
    from grample_tpu.sampler.chains import ChainGroup

    if mesh is None:
        g = ChainGroup(model, chains_per_variant=chains, converge_window=window, seed=seed)
    else:
        from grample_tpu.parallel.mesh import ShardedChainGroup

        g = ShardedChainGroup(model, chains_per_variant=chains,
                              converge_window=window, seed=seed, mesh=mesh)
    g.reserve(n_slots)
    g.add_variants([model] * n_slots)
    g.warmup()
    g.burn(burn)
    t0 = time.perf_counter()
    for _ in range(windows):
        g.advance(window)
    dt = time.perf_counter() - t0
    est = norm_marginals(g.merged_marginals(), model.cards)
    free = model.fixed < 0
    err = float(np.max(np.abs(est[free] - exact[free])))
    sigma = np.sqrt(0.25 / (chains * n_slots))
    bound = 5 * sigma + 0.5 / (1 + windows * window)
    st = np.asarray(g.state)[:n_slots, :, : model.num_vars]
    pinned = np.all(st[:, :, ~free] == model.fixed[~free][None, None, :])
    if not pinned:
        raise AssertionError("evidence variables moved during sampling")
    return g, err, float(bound), dt


def sweep_rate(model, chains, sweeps, seed) -> float:
    """Uncounted sweeps/s of a plain group at ``chains`` chains (after
    a compiling warm-up)."""
    from grample_tpu.sampler.chains import ChainGroup

    g = ChainGroup(model, chains_per_variant=chains, converge_window=sweeps, seed=seed)
    g.add_variant(model)
    g.warmup()
    g.burn(8)
    jax.block_until_ready(g.state)
    t0 = time.perf_counter()
    g.burn(sweeps)
    jax.block_until_ready(g.state)
    return sweeps / (time.perf_counter() - t0)


# ---------------------------------------------------------------- phase 4
def read_trace(path: str) -> tuple:
    """(evidence {var: value}, result summary dict) from an engine trace."""
    evidence, summary, section = {}, None, ""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("//"):
                section = line
                continue
            if section == "// EVIDENCE" and line:
                rec = json.loads(line)
                evidence[int(rec["ID"])] = int(rec["FixedVal"])
            elif section == "// RESULT SUMMARY" and line:
                summary = json.loads(line)
    return evidence, summary


def cli_run(path, sampler, vchains, maxsecs, out_dir, exact, model_ev,
            evidence, seed, extra=()) -> dict:
    """One ``grample_tpu.cli sample`` run, in process; checks and scores."""
    from grample_tpu import cli
    from grample_tpu.metrics import error_suite
    from grample_tpu.metrics.divergences import pad_marginals
    from grample_tpu.pgm.discrete import uniform_marginals
    from grample_tpu.uai import read_mar_file

    tag = sampler + ("_mesh" if extra else "")
    mar = os.path.join(out_dir, f"cli_{tag}.MAR")
    trace = os.path.join(out_dir, f"cli_{tag}.trace")
    # burn-in 500 sweeps and 200-sweep windows (the flags count
    # single-site samples): adaptation runs in the first half of the
    # budget, so the default 2000-sweep burn-in and window would leave
    # it no tick to act in
    v = model_ev.num_vars
    argv = ["sample", "-m", path, "-d", "-o", "-s", sampler, "-c", "2",
            "-b", str(500 * v), "-w", str(200 * v),
            "--vchains", str(vchains), "--maxsecs", str(maxsecs),
            "--mar-out", mar, "-t", trace, "-e", str(seed), *extra]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"cli_{tag}.log"), "w") as fh:
        fh.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"cli {sampler} exited {rc}")
    est = pad_marginals(read_mar_file(mar), model_ev.cards)
    if not np.all(np.isfinite(est)) or not np.allclose(est.sum(axis=1), 1.0, atol=1e-6):
        raise AssertionError(f"cli {sampler}: marginals not finite and normalised")
    ev_seen, summary = read_trace(trace)
    if ev_seen != evidence:
        raise AssertionError(f"cli {sampler}: evidence not pinned as given: {ev_seen}")
    fin = error_suite(est, exact, model_ev.cards, model_ev.fixed, None)
    start = error_suite(uniform_marginals(model_ev.cards), exact,
                        model_ev.cards, model_ev.fixed, None)
    if not fin.mean_hellinger < start.mean_hellinger:
        raise AssertionError(
            f"cli {sampler}: final mean Hellinger {fin.mean_hellinger} not below "
            f"START {start.mean_hellinger}")
    return {"sampler": sampler, "wall_s": wall,
            "start_mean_hellinger": start.mean_hellinger,
            "mean_hellinger": fin.mean_hellinger, "max_hellinger": fin.max_hellinger,
            "samples": summary["samples"], "samples_per_sec": summary["samples_per_sec"],
            "variants": summary["variants"], "collapsed": summary["collapsed"]}


def memory_line(devs) -> str:
    return json.dumps([
        {"device": d.id, "bytes_in_use": d.memory_stats().get("bytes_in_use"),
         "peak_bytes_in_use": d.memory_stats().get("peak_bytes_in_use")}
        for d in devs])


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path over four cards")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="smoke_out",
                    help="directory for generated nets, logs and traces")
    ap.add_argument("--maxsecs", type=float, default=30.0,
                    help="sampling budget of each CLI run")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    # ---- phase 0: device
    devs = require_gpu()
    if len(devs) < args.cards:
        raise RuntimeError(f"--cards {args.cards} needs {args.cards} GPUs, found {len(devs)}")
    devs = devs[: args.cards]
    kind = devs[0].device_kind
    log(f"[0] device: platform={devs[0].platform} kind={kind!r} count={len(jax.devices())} "
        f"jax={jax.__version__}")
    log(f"[0] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={jax.config.jax_compilation_cache_dir!r}")
    smi = nvidia_smi()
    log(f"[0] nvidia-smi name,power.limit: {smi}")
    os.makedirs(args.out, exist_ok=True)

    # ---- phase 1: generated nets + exact marginals
    t0 = time.perf_counter()
    strong, evidence = grid_net(coupling=10.0, seed=args.seed)
    weak, _ = grid_net(coupling=0.5, seed=args.seed)
    strong_ev, weak_ev = with_evidence(strong, evidence), with_evidence(weak, evidence)
    exact_strong = grid_exact(strong_ev, SIDE)
    exact_weak = grid_exact(weak_ev, SIDE)
    path = write_net(args.out, "grid10_strong", strong, evidence, exact_strong)
    log(f"[1] nets: {strong.num_vars} vars, {len(strong.factors)} factors, "
        f"{len(evidence)} evidence vars; exact by row transfer "
        f"({time.perf_counter() - t0:.2f} s)")

    if args.cards == 4:
        return main_cards4(args, devs, kind, weak_ev, exact_weak, path,
                           exact_strong, strong_ev, evidence, t_all)

    # ---- phase 2: sweep logits vs float64 reference at full width
    t0 = time.perf_counter()
    state = random_state(strong_ev, CHAINS, args.seed)
    ref = reference_logits(strong_ev, state)
    for mode in SWEEP_MODES:
        tm = time.perf_counter()
        err = logits_max_error(strong_ev, mode, state, ref)
        log(f"[2] logits {mode:9s} @ {CHAINS} chains: max abs err {err:.3e} "
            f"(tol {LOGITS_TOL:g}) ({time.perf_counter() - tm:.2f} s)")
        if not err <= LOGITS_TOL:
            raise AssertionError(f"{mode} logits off by {err}")
    del ref, state
    print_memory_analysis(strong_ev, CHAINS)
    log(f"[2] done ({time.perf_counter() - t0:.2f} s)")

    # ---- phase 3: sampler vs exact at full width
    t0 = time.perf_counter()
    burn, windows, window = 200, 4, 250
    g, err, bound, dt = sampler_check(weak_ev, exact_weak, CHAINS, burn, windows,
                                      window, args.seed)
    sites = int(weak_ev.free_mask.sum())
    log(f"[3] sampler @ {CHAINS} chains, {windows}x{window} counted sweeps: "
        f"max abs marginal err {err:.3e} (bound {bound:.3e} = 5 sigma + prior)")
    if not err < bound:
        raise AssertionError(f"sampler error {err} over bound {bound}")
    log(f"[3] counted windows: {windows * window / dt:.1f} sweeps/s, "
        f"{windows * window * CHAINS * sites / dt:.4g} site-samples/s "
        f"(smoke, not a benchmark)")
    for c in (16384, CHAINS):
        r = sweep_rate(weak_ev, c, 500, args.seed)
        log(f"[3] uncounted burn @ {c} chains: {r:.1f} sweeps/s, "
            f"{r * c * sites:.4g} site-samples/s (smoke, not a benchmark)")
    tr = trace_window(g, 64, os.path.join(args.out, "trace"))
    by = sweep_bytes(g.caps, CHAINS)
    per_sweep = tr["busy_ns"] / tr["sweeps"] * 1e-9
    peak = next((v for k, v in PEAK_HBM_BYTES_PER_S.items() if kind.startswith(k)), None)
    share = "not in peaks table" if peak is None or per_sweep <= 0 else \
        f"{by['total'] / per_sweep / peak:.4f}"
    idle = 1.0 - tr["busy_ns"] / max(tr["kernel_span_ns"], 1)
    log(f"[3] trace of one counted {tr['sweeps']}-sweep window @ {CHAINS} chains: "
        f"device busy {per_sweep * 1e3:.4f} ms/sweep, device span "
        f"{tr['kernel_span_ns'] / tr['sweeps'] * 1e-6:.4f} ms/sweep, idle share in span "
        f"{idle:.4f}, traced wall {tr['wall_s'] / tr['sweeps'] * 1e3:.4f} ms/sweep, "
        f"{tr['kernels'] / tr['sweeps']:.1f} device events/sweep")
    log(f"[3] bytes/sweep from shapes {json.dumps(by)}; "
        f"{by['total'] / max(per_sweep, 1e-12) / 1e9:.1f} GB/s; share of HBM peak {share} "
        f"(sweep_mode={g.caps.sweep_mode}, NVp={g.caps.num_rows}, NC={g.caps.color_cap}, "
        f"G={g.caps.group_cap}, F={g.caps.adj_cap}, OA={g.caps.oa_cap}, K={g.caps.max_card})")
    del g
    log(f"[3] done ({time.perf_counter() - t0:.2f} s)")

    # ---- phase 4: end to end through the CLI
    for sampler in ("simple", "adaptive", "collapsed"):
        res = cli_run(path, sampler, CHAINS // 2, args.maxsecs, args.out, exact_strong,
                      strong_ev, evidence, args.seed)
        if sampler == "adaptive" and not res["collapsed"]:
            raise AssertionError("adaptive run added no collapse variant")
        log(f"[4] cli {sampler}: {json.dumps(res)}")
        log(f"[4] memory: {memory_line(devs)}")

    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(jax.devices())}}))
    return 0


def main_cards4(args, devs, kind, weak_ev, exact_weak, path, exact_strong,
                strong_ev, evidence, t_all) -> int:
    """The four-card path: the sharded sampler check and an adaptive CLI
    run over ``--mesh auto``; nothing else."""
    from grample_tpu.parallel.mesh import chain_mesh

    t0 = time.perf_counter()
    mesh = chain_mesh(4)
    burn, windows, window, slots = 200, 4, 250, 2
    g, err, bound, dt = sampler_check(weak_ev, exact_weak, CHAINS, burn, windows,
                                      window, args.seed, mesh=mesh, n_slots=slots)
    sites = int(weak_ev.free_mask.sum())
    want = slots * CHAINS * windows * window * sites
    counted = g.total_samples
    log(f"[5] sharded sampler on mesh {dict(mesh.shape)}: {slots} slots x {CHAINS} chains, "
        f"max abs marginal err {err:.3e} (bound {bound:.3e}); counted samples "
        f"{counted} (want {want}); {windows * window / dt:.1f} sweeps/s "
        f"(smoke, not a benchmark)")
    if counted != want:
        raise AssertionError(f"counted {counted} samples, want {want}")
    if not err < bound:
        raise AssertionError(f"sharded sampler error {err} over bound {bound}")
    log(f"[5] memory per card: {memory_line(devs)}")
    del g
    res = cli_run(path, "adaptive", 2 * CHAINS, args.maxsecs, args.out,
                  exact_strong, strong_ev, evidence, args.seed,
                  extra=("--mesh", "auto"))
    if not res["collapsed"]:
        raise AssertionError("adaptive mesh run added no collapse variant")
    log(f"[5] cli adaptive --mesh auto: {json.dumps(res)}")
    log(f"[5] memory per card: {memory_line(devs)}")
    log(f"[done] {time.perf_counter() - t_all:.1f} s (phase 5 {time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
