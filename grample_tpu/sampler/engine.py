"""Run orchestration: the ``modelMarginals`` equivalent.

Drives a full marginal-estimation run (reference ``cmd/root.go:309-719``):
load model + evidence + solutions, build the chain group, burn in, then
loop advance → score → adapt under time/iteration budgets, and emit the
final report, trace records, and MAR output.

Reference flag units are single-site samples; this engine works in
*sweeps* (one sweep resamples every free variable once).  Conversions:
``burnin`` samples ≈ ``burnin / V`` sweeps, matching the reference
default burnin = 2000·V  →  2000 sweeps.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from grample_tpu.metrics import ErrorSuite, error_suite
from grample_tpu.metrics.divergences import pad_marginals
from grample_tpu.pgm.discrete import DiscreteModel, norm_marginals
from grample_tpu.sampler.adaptive import adapt_step
from grample_tpu.sampler.chains import MAX_VARIANTS, ChainGroup
from grample_tpu.sampler.collapse import collapse_var, pick_random_collapsible
from grample_tpu.uai import load_model, read_mar_file

#: Max seconds of batched device work per engine tick (see the nwin
#: computation): bounds the scoring/adapt/RB cadence when status output
#: is quiet, balancing dispatch overhead against adaptation granularity.
TICK_WORK_SECS = 30.0

#: Tick budget while adaptation is live: shorter ticks mean more adapt
#: rounds inside the half-budget adapt window (the reference adapts at
#: its ~5 s scoring cadence, cmd/root.go:498-547; 30 s ticks gave a
#: 300 s wall run only 2-3 rounds and the worst-PSRF ranking never
#: reached past the first few clusters)
ADAPT_TICK_WORK_SECS = 10.0


@dataclasses.dataclass
class EngineConfig:
    model_path: str
    use_evidence: bool = False
    use_solution: bool = False
    sampler: str = "simple"  # simple | collapsed | adaptive
    burnin: int = -1  # single-site samples; <0 → 2000·V (2000 sweeps)
    converge_window: int = 0  # single-site samples; <=0 → burnin
    chains: int = 0  # logical chains (variant slots); <=0 → 2
    chains_per_variant: int = 64  # micro-chains per slot (the batch axis)
    chain_adds: int = 1  # new chains per adapt step (adaptive only)
    max_iters: int = 0  # site updates; 0 = unlimited, <0 → 20000·V
    max_secs: float = 300.0
    # budget semantics: "sampling" excludes compile time (off-clock
    # warmup + adapt-compile compensation — runs compare at matched
    # sampling effort; wall can reach ~2x nominal) while "wall" is the
    # reference's literal contract (cmd/root.go:204,473-561): max_secs
    # bounds wall clock from run start, warmup and compiles on the clock,
    # no compensation
    budget: str = "sampling"
    seed: int = 0  # <1 → wall clock
    measure: str = "hellinger"
    adapt_policy: str = "worst"  # worst | ref-tail
    warm_start: bool = True
    # tempered burn-in stages (0 = plain uniform-init burn, the
    # reference-faithful quench; see ChainGroup.burn_annealed)
    anneal_stages: int = 20
    # Rao-Blackwell mixture estimator for collapsed vars (False = the
    # reference's static collapse-time marginal; see rb_accumulate)
    rb_mixture: bool = True
    trace_path: str = ""
    experiment: bool = False
    verbose: bool = False
    status_secs: float = 5.0
    mar_out: str = ""  # write final MAR solution here
    checkpoint_path: str = ""
    checkpoint_secs: float = 60.0
    resume: bool = False
    max_variants: int = MAX_VARIANTS
    # pre-size variant slots (0 = just the starting chains).  Adaptive
    # runs that will grow to many variants should reserve up front: slot
    # growth re-stacks device arrays and recompiles the sweep per
    # power-of-two step, each a compile on the run's clock.
    reserve_slots: int = 0
    # split execution for adaptive runs: "on" = a SplitChainGroup
    # (full-width plain slots + reduced-chain collapse slots, see
    # sampler/split.py); "auto" and "off" = one ChainGroup.  Ignored
    # under a device mesh.
    split_group: str = "auto"
    # device mesh: "off" = single-device ChainGroup; "auto" = shard over
    # all visible devices when more than one; "VxC" (e.g. "2x4") = explicit
    # (variants, chains) mesh shape
    mesh: str = "off"

    def resolve_seed(self) -> int:
        if self.seed >= 1:
            return self.seed
        t = time.localtime()
        return int(t.tm_sec + t.tm_min + time.time_ns() % 1_000_000_007)


@dataclasses.dataclass
class RunResult:
    marginals: np.ndarray  # [V, K] normalized final estimate
    model: DiscreteModel
    samples: int
    sweeps: int
    runtime: float
    chains: int
    variants: int
    collapsed: List[int]
    final_score: Optional[ErrorSuite] = None
    merlin_score: Optional[ErrorSuite] = None
    score_vs_merlin: Optional[ErrorSuite] = None
    convergence: Optional[Dict[str, np.ndarray]] = None
    samples_per_sec: float = 0.0
    aux_secs: float = 0.0  # split execution: wall spent on the aux group


class Engine:
    """One marginal-estimation run."""

    def __init__(
        self,
        cfg: EngineConfig,
        log: Callable[[str], None] = print,
        monitor=None,
    ):
        self.cfg = cfg
        self.log = log
        self.monitor = monitor
        self.trace_fh = None
        if cfg.trace_path:
            self.trace_fh = open(cfg.trace_path, "w")
        if cfg.experiment and not cfg.trace_path:
            raise ValueError("experiment mode requires a trace file")

    def trace(self, line: str):
        if self.trace_fh:
            self.trace_fh.write(line + "\n")
            self.trace_fh.flush()

    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        cfg = self.cfg
        t_start = time.time()

        self.log(f"Reading model from {cfg.model_path}")
        model = load_model(cfg.model_path, use_evidence=cfg.use_evidence)
        v = model.num_vars
        self.log(f"Model has {v} vars and {len(model.factors)} functions")

        solution = None
        merlin = None
        if cfg.use_solution:
            sol_path = cfg.model_path + ".MAR"
            solution = pad_marginals(read_mar_file(sol_path), model.cards)
            start = error_suite(model.marginals, solution, model.cards, model.fixed, None)
            self.log(f"START {start}")
            if cfg.verbose:
                self.log(start.report())
            mer_path = cfg.model_path + ".merlin.MAR"
            if os.path.exists(mer_path):
                merlin = pad_marginals(read_mar_file(mer_path), model.cards)

        # ---- derived defaults (reference cmd/root.go:344-363) ----------
        seed = cfg.resolve_seed()
        burn_sweeps = 2000 if cfg.burnin < 0 else max(0, math.ceil(cfg.burnin / v))
        cw_sweeps = (
            burn_sweeps if cfg.converge_window <= 0
            else max(2, math.ceil(cfg.converge_window / v))
        )
        cw_sweeps = max(2, cw_sweeps)
        n_slots = cfg.chains if cfg.chains > 0 else 2
        n_slots = max(2 if cfg.sampler == "adaptive" else 1, n_slots)
        # reference cmd/root.go:352-358: negative maxiters derives
        # 20000·|vars|; the flag default 0 means unlimited (time-bounded)
        max_iters = 20000 * v if cfg.max_iters < 0 else cfg.max_iters
        if cfg.sampler != "adaptive" and cfg.chain_adds != 1:
            raise ValueError(f"sampler is not adaptive: chain_adds={cfg.chain_adds} makes no sense")

        self.log(
            f"sampler={cfg.sampler} seed={seed} burnin={burn_sweeps} sweeps "
            f"cwin={cw_sweeps} sweeps chains={n_slots}x{cfg.chains_per_variant} "
            f"maxsecs={cfg.max_secs} maxiters={max_iters}"
        )

        prior_runtime = 0.0
        if cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
            from grample_tpu.sampler.checkpoint import load_checkpoint

            # resume honors --mesh: the factory reconstructs a sharded
            # group when configured (r2 silently dropped the mesh here)
            group, meta = load_checkpoint(
                cfg.checkpoint_path, model, make_group=self._group_factory(cfg)
            )
            cw_sweeps = group.cw
            prior_runtime = float(meta.get("runtime", 0.0))
            self.log(
                f"RESUMED from {cfg.checkpoint_path}: {group.num_variants} "
                f"chains, {group.total_samples:,} samples, "
                f"{group.total_sweeps} sweeps, {prior_runtime:.1f}s spent"
            )
            group.warmup()  # compile off the budget clock
            t_clock = t_start if cfg.budget == "wall" else time.time()
        else:
            # rnd (random-collapse): build the WHOLE variant set up
            # front so the group encodes against exact measured caps
            # instead of the far wider collapse-headroom estimates
            prebuilt = None
            caps = None
            if cfg.sampler == "collapsed":
                from grample_tpu.pgm.encode import (
                    COLLAPSE_OA_DENSE_CAP,
                    caps_for_variants,
                )

                rng = np.random.default_rng(seed)
                prebuilt = []
                for slot in range(n_slots):
                    var = pick_random_collapsible(
                        model, rng, oa_cap=COLLAPSE_OA_DENSE_CAP
                    )
                    if var is None:
                        prebuilt.append((None, model))
                    else:
                        variant, exact = collapse_var(model, var)
                        self.log(f" ... chain {slot + 1}: collapsed var {var} "
                                 f"marginal={np.round(exact, 4)}")
                        prebuilt.append((var, variant))
                caps = caps_for_variants(
                    [mv for _, mv in prebuilt], slot_hint=n_slots
                )
            elif cfg.sampler not in ("simple", "adaptive"):
                raise ValueError(f"unknown sampler: {cfg.sampler}")
            group = self._make_group(cfg, model, cw_sweeps, seed, caps=caps)
            self.log(f"Creating chains and performing burn-in ({burn_sweeps} sweeps)")
            reserve = max(n_slots, cfg.reserve_slots)
            if cfg.sampler == "adaptive" and cfg.reserve_slots == 0:
                # full-capacity reservation when the device footprint is
                # small: every pow2 slot growth otherwise restacks device
                # arrays AND recompiles the sweep/PSRF/RB programs on the
                # budget clock (measured 62% of a Grids_13 adaptive run).
                # SplitChainGroup caps its own main reserve at 8, so this
                # only sizes single-group (Grids-class) runs; the bytes
                # gate keeps wide nets (Promedus-class vchains) lazy.
                reserve = max(reserve, self._auto_reserve(cfg, group))
            group.reserve(reserve)
            group.add_variants(
                [model] * n_slots if prebuilt is None
                else [mv for _, mv in prebuilt]
            )
            group.warmup()  # wall mode: warmup runs ON the clock
            if cfg.sampler == "adaptive" and hasattr(group, "prewarm_aux"):
                # synchronous aux build+compile, AFTER the main warmup
                # and BEFORE the sampling-budget clock anchors: it is
                # compile work, the class of cost that budget excludes
                # (wall mode anchors at t_start, so there it stays on
                # the clock either way)
                group.prewarm_aux()
            t_clock = t_start if cfg.budget == "wall" else time.time()
            if cfg.anneal_stages > 0:
                group.burn_annealed(burn_sweeps, cfg.anneal_stages)
            else:
                group.burn(burn_sweeps)

        if self.monitor:
            self.monitor.update(
                burnin=burn_sweeps, cwin=cw_sweeps, chains=group.num_chains,
                variants=group.num_variants, maxsecs=cfg.max_secs,
            )

        if cfg.experiment:
            self.trace("// EXPERIMENT RESULTS")
            self.trace("RunSecs, MaxHell, NegLogMaxHell, MaxJS, NegLogMaxJS, CollapseCount")

        # ---- main loop --------------------------------------------------
        # budgets anchor at t_clock (model load + compiles excluded;
        # burn-in included, matching the reference) and continue across
        # resume: prior runtime is already spent
        stop_time = t_clock + max(0.0, cfg.max_secs - prior_runtime)
        next_status = t_clock + cfg.status_secs / 2
        no_adapt_time = t_clock + max(0.0, cfg.max_secs / 2 - prior_runtime)
        next_checkpoint = t_clock + cfg.checkpoint_secs
        keep_adapting = cfg.sampler == "adaptive"
        keep_working = True
        score = None
        # total budget-clock compensation allowance for adapt-time
        # compiles (see below): bounded so a pathological compile storm
        # cannot extend the run past ~2x the configured budget
        if cfg.budget not in ("sampling", "wall"):
            raise ValueError(f"unknown budget mode {cfg.budget!r}")
        comp_left = 0.0 if cfg.budget == "wall" else max(60.0, cfg.max_secs)

        win_time = None  # EMA: measured seconds per counted window
        while keep_working:
            # Dispatch a BATCH of windows with deferred count deltas (no
            # host sync between windows), sized so one batch ≈ the status
            # cadence: the device stays busy while the host only scores/
            # adapts every ~status_secs, matching the reference's ~5s
            # scoring loop (cmd/root.go:498-539).  r2 scored+synced every
            # window and converted <3% of sweep speed into inference.
            if win_time is None:
                nwin = 1
            else:
                # batch bound: at most ~status_secs of device work per
                # tick, and never more than TICK_WORK_SECS even when the
                # status cadence is quiet (acceptance runs set
                # status_secs=1e9; the old flat 64-window cap gave
                # Grids-class runs 160 s ticks — 2 adapt steps per 300 s
                # run — while Promedus-class runs ticked every 10 s and
                # paid the aux+adapt overhead 3x more often than needed)
                budget = min(
                    cfg.status_secs,
                    ADAPT_TICK_WORK_SECS if keep_adapting else TICK_WORK_SECS,
                    max(stop_time - time.time(), 0.25),
                )
                nwin = max(1, min(1024, int(budget / max(win_time, 1e-4))))
            t_w0 = time.time()
            for _ in range(nwin):
                group.advance(cw_sweeps, defer=True)
            group.flush()
            dt = (time.time() - t_w0) / nwin
            win_time = dt if win_time is None else 0.5 * win_time + 0.5 * dt
            now = time.time()
            if cfg.max_secs > 0 and now > stop_time:
                keep_working = False
            if max_iters > 0 and group.total_samples > max_iters:
                keep_working = False

            # RB mixture snapshot: one per loop tick — ticks are a window+
            # apart, so chain states are decorrelated between snapshots
            group.rb_accumulate()

            if now > next_status or not keep_working or cfg.experiment:
                runtime = now - t_clock
                if now > next_status or not keep_working:
                    rate = group.total_samples / max(runtime, 1e-9)
                    self.log(
                        f"  Samps: {group.total_samples:>14,d} | RT {runtime:10.2f}s"
                        f" | {rate:,.0f} samples/s | chains {group.num_chains}"
                    )
                if solution is not None:
                    merged = group.merged_marginals()
                    score = error_suite(merged, solution, model.cards, model.fixed, None)
                    if now > next_status or not keep_working:
                        self.log(score.report() if cfg.verbose else f"    {score}")
                    if cfg.experiment:
                        ncol = int(group.collapsed_any().sum())
                        self.trace(
                            f"{runtime:.1f}, {score.max_hellinger:.8f}, "
                            f"{_neglog2(score.max_hellinger):.5f}, {score.max_js:.8f}, "
                            f"{_neglog2(score.max_js):.5f}, {ncol}"
                        )
                if self.monitor:
                    self.monitor.update(
                        iterations=group.total_samples, runtime=now - t_start,
                        chains=group.num_chains, variants=group.num_variants,
                        **(_score_vars(score) if score else {}),
                    )
                if now > next_status:
                    next_status = now + cfg.status_secs

            if keep_adapting and now > no_adapt_time:
                self.log("STOPPING ADAPTATION")
                keep_adapting = False
            if keep_working and keep_adapting and getattr(
                group, "adapt_ready", lambda: True
            )():
                t_adapt = time.time()
                added = adapt_step(
                    group, cfg.chain_adds, measure=cfg.measure,
                    policy=cfg.adapt_policy, warm_start=cfg.warm_start,
                )
                if added:
                    # compile compensation: growing into new collapse
                    # variants compiles device programs (aux group
                    # creation, slot/caps growth) — a compile cost with
                    # no reference analogue (its Collapse costs ms,
                    # cmd/root.go:542-547).  Extend the budget by the
                    # adapt time beyond a scalar-work allowance so runs
                    # compare at matched SAMPLING budget; the wall time
                    # is still reported honestly by callers.
                    comp = min(
                        comp_left, max(0.0, (time.time() - t_adapt) - 0.5)
                    )
                    comp_left -= comp
                    stop_time += comp
                    no_adapt_time += comp
                    self.log(
                        f"ADAPT: {group.num_variants} chains "
                        f"(+{len(added)}: collapsed vars {added})"
                    )

            if cfg.checkpoint_path and time.time() > next_checkpoint:
                self.save_checkpoint(
                    group, prior_runtime + (time.time() - t_clock)
                )
                next_checkpoint = time.time() + cfg.checkpoint_secs

        # ---- final ------------------------------------------------------
        runtime = time.time() - t_clock
        if hasattr(group, "join_prewarm"):
            group.join_prewarm()  # never exit with a compile thread live
        merged = group.merged_marginals()
        final = norm_marginals(merged, model.cards)
        self.log("DONE")

        result = RunResult(
            marginals=final,
            model=model,
            samples=group.total_samples,
            sweeps=group.total_sweeps,
            runtime=runtime,
            chains=group.num_chains,
            variants=group.num_variants,
            collapsed=sorted(int(x) for x in np.nonzero(group.collapsed_any())[0]),
            samples_per_sec=group.total_samples / max(runtime, 1e-9),
            aux_secs=float(getattr(group, "aux_secs", 0.0)),
        )

        if solution is not None:
            result.final_score = error_suite(final, solution, model.cards, model.fixed, None)
            self.log(f"FINAL {result.final_score}")
            self.log(result.final_score.report())
            if merlin is not None:
                result.merlin_score = error_suite(merlin, solution, model.cards, model.fixed, None)
                self.log(f"MERLIN SCORE {result.merlin_score}")
                result.score_vs_merlin = error_suite(final, merlin, model.cards, model.fixed, None)
                self.log(f"OUR SCORE USING MERLIN AS SOLUTION {result.score_vs_merlin}")

        result.convergence = {
            meas: group.convergence(measure=meas)
            for meas in ("hellinger", "js", "maxabs", "meanabs")
        }

        if cfg.verbose:
            # reference --verbose: per-variable final summaries
            # (cmd/root.go:677-685; true per-sample logging is meaningless
            # at billions of vectorized site updates per second)
            for i in range(v):
                kind = "EVID" if model.fixed[i] >= 0 else "est"
                self.log(
                    f"Variable[{i}] {model.var_name(i)} (Card:{int(model.cards[i])}, "
                    f"{kind}) {np.round(result.marginals[i, :int(model.cards[i])], 6)}"
                )

        self._final_trace(result, solution, merlin)

        if cfg.mar_out:
            from grample_tpu.uai.writer import write_mar

            mars = [final[i, : model.cards[i]] for i in range(v)]
            with open(cfg.mar_out, "w") as fh:
                fh.write(write_mar(mars))
            self.log(f"Wrote MAR solution to {cfg.mar_out}")

        if self.trace_fh:
            self.trace_fh.close()
        return result

    # ------------------------------------------------------------------
    def _final_trace(self, result: RunResult, solution, merlin):
        """Per-variable JSON trace records (reference cmd/root.go:656-716)."""
        if not self.trace_fh:
            return
        from grample_tpu.metrics.divergences import (
            hellinger,
            js_divergence,
            max_abs_diff,
            mean_abs_diff,
        )

        model = result.model
        conv = result.convergence
        # evidence-fixed vars contribute zero to every per-var error
        # record (reference ErrorSuite, model/error.go:44-49)
        err = None
        if solution is not None:
            err = {
                "Hell-Error": hellinger(result.marginals, solution, model.cards, model.fixed),
                "JS-Error": js_divergence(result.marginals, solution, model.cards, model.fixed),
                "MaxAD-Error": max_abs_diff(result.marginals, solution, model.cards, model.fixed),
                "AvgAD-Error": mean_abs_diff(result.marginals, solution, model.cards, model.fixed),
            }
        mer_hell = None
        if merlin is not None:
            mer_hell = hellinger(result.marginals, merlin, model.cards, model.fixed)

        def var_record(i: int, with_merlin: bool = False) -> dict:
            card = int(model.cards[i])
            rec = {
                "ID": i,
                "Name": model.var_name(i),
                "Card": card,
                "FixedVal": int(model.fixed[i]),
                "Collapsed": bool(i in result.collapsed),
                "Marginal": [float(x) for x in result.marginals[i, :card]],
                "State": {
                    "Hell-Convergence": float(conv["hellinger"][i]),
                    "JS-Convergence": float(conv["js"][i]),
                    "MaxAD-Convergence": float(conv["maxabs"][i]),
                    "AvgAD-Convergence": float(conv["meanabs"][i]),
                },
            }
            if solution is not None:
                for c in range(card):
                    rec["State"][f"SOL-MAR[{c}]"] = float(solution[i, c])
                for name, vals in err.items():
                    rec["State"][name] = float(vals[i])
            if with_merlin and mer_hell is not None:
                rec["State"]["MerlinHellError"] = float(mer_hell[i])
            return rec

        self.trace("// EVIDENCE")
        for i in range(model.num_vars):
            if model.fixed[i] >= 0:
                self.trace(json.dumps(var_record(i)))
        self.trace("// VARS (ESTIMATED)")
        for i in range(model.num_vars):
            if model.fixed[i] < 0:
                self.trace(json.dumps(var_record(i)))
        if mer_hell is not None:
            # reference cmd/root.go:689-709: estimated vars ranked by
            # Hellinger distance from the merlin solution
            order = sorted(
                (i for i in range(model.num_vars) if model.fixed[i] < 0),
                key=lambda i: mer_hell[i],
            )
            self.trace("// VARS SORTED BY DIST FROM HELLINGER")
            for i in order:
                self.trace(json.dumps(var_record(i, with_merlin=True)))
        self.trace("// OPERATING PARAMS")
        self.trace(json.dumps(dataclasses.asdict(self.cfg)))
        self.trace("// RESULT SUMMARY")
        self.trace(
            json.dumps(
                {
                    "samples": result.samples,
                    "sweeps": result.sweeps,
                    "runtime": result.runtime,
                    "chains": result.chains,
                    "variants": result.variants,
                    "collapsed": result.collapsed,
                    "samples_per_sec": result.samples_per_sec,
                    "aux_secs": result.aux_secs,
                    "final_score": result.final_score.as_dict() if result.final_score else None,
                }
            )
        )
        # reference cmd/root.go:714-716: the whole model (factor tables
        # excluded from JSON, matching model/model.go:28)
        self.trace("// ENTIRE MODEL")
        self.trace(
            json.dumps(
                {
                    "Type": model.type,
                    "Name": model.name,
                    "Vars": [var_record(i) for i in range(model.num_vars)],
                }
            )
        )

    def _make_group(self, cfg: EngineConfig, model, cw_sweeps: int,
                    seed: int, caps=None):
        # exact pre-measured caps (rnd mode): headroom is pointless, the
        # variant set is already known
        kw = {} if caps is None else {"caps": caps}
        return self._group_factory(cfg)(
            model,
            chains_per_variant=cfg.chains_per_variant,
            converge_window=cw_sweeps,
            seed=seed,
            collapse_headroom=(
                caps is None and cfg.sampler in ("adaptive", "collapsed")
            ),
            rb_mixture=cfg.rb_mixture,
            **kw,
        )

    def _group_factory(self, cfg: EngineConfig):
        """Factory: ChainGroup, or ShardedChainGroup over a device mesh.

        Sharded mode re-expresses the reference's goroutine-per-chain
        parallelism (``sampler/chain.go:197-215``) as the
        ``(variants, chains)`` mesh of ``parallel/mesh.py``: sweeps run
        communication-free under shard_map; MergeChains/PSRF reductions
        are collectives.  Used both for fresh runs and for
        checkpoint resume (which overrides the shape keywords).
        """

        def make(model, **kw):
            import jax

            kw.setdefault("max_variants", cfg.max_variants)
            use_mesh = cfg.mesh not in ("", "off") and (
                cfg.mesh != "auto" or len(jax.devices()) > 1
            )
            if not use_mesh:
                if cfg.sampler == "adaptive" and cfg.split_group == "on":
                    from grample_tpu.sampler.split import SplitChainGroup

                    self.log("split group: full-width plain slots + "
                             "reduced-chain collapse slots")
                    return SplitChainGroup(model, **kw)
                return ChainGroup(model, **kw)

            from grample_tpu.parallel.mesh import ShardedChainGroup, chain_mesh

            if cfg.mesh == "auto":
                mesh = chain_mesh()
            else:
                vways, _, cways = cfg.mesh.partition("x")
                mesh = chain_mesh(
                    n_devices=int(vways) * int(cways), variant_ways=int(vways)
                )
            self.log(f"device mesh: {dict(mesh.shape)} over {mesh.size} devices")
            return ShardedChainGroup(model, mesh=mesh, **kw)

        return make

    @staticmethod
    def _auto_reserve(cfg: EngineConfig, group) -> int:
        """Slots to pre-reserve for an adaptive run (0 = stay lazy).

        Estimates the full-capacity device footprint (stacked encodings
        + state + window halves) from the group's caps; reserves
        ``max_variants`` only when that footprint is at most 1 GiB, else
        0 (lazy pow2 growth).  The bound selects between the two growth
        policies; re-deriving it from the device's memory is a measured
        change (ROADMAP queue 1 item 8)."""
        caps = getattr(group, "caps", None)
        if caps is None:  # SplitChainGroup manages its own reserve
            return 0
        import numpy as np

        from grample_tpu.pgm.encode import encode_model

        try:
            enc = encode_model(group.base, caps)
        except ValueError:
            return 0
        enc_bytes = sum(np.asarray(v).nbytes for v in enc.arrays().values())
        cpv, v1, k = group.cpv, caps.num_vars + 1, caps.max_card
        per_slot = enc_bytes + cpv * v1 * 4 + 2 * cpv * v1 * k * 4
        total = per_slot * cfg.max_variants
        return cfg.max_variants if total <= (1 << 30) else 0

    def save_checkpoint(self, group: ChainGroup, runtime: float = 0.0):
        from grample_tpu.sampler.checkpoint import save_checkpoint

        save_checkpoint(self.cfg.checkpoint_path, group, self.cfg, runtime=runtime)
        self.log(f"checkpoint -> {self.cfg.checkpoint_path}")


def _neglog2(x: float) -> float:
    return -math.log2(max(x, 1e-300))


def _score_vars(score: ErrorSuite) -> dict:
    return {
        "mean_hellinger": score.mean_hellinger,
        "max_hellinger": score.max_hellinger,
        "mean_js": score.mean_js,
        "max_js": score.max_js,
    }


