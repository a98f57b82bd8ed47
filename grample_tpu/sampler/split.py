"""Split chain group: fast plain slots + slow collapse slots.

On Promedus-class nets the collapse-headroom capacities are far wider
than the plain ones (dense-256 replacement factors push ``oa_cap`` up,
and at 128 slot hints the Wbase budget forces the rowgather tier), so a
single adaptive :class:`~grample_tpu.sampler.chains.ChainGroup` would
pay the widest encoding for EVERY chain.

This wrapper keeps the reference semantics (``MergeChains``,
``sampler/chain.go:96-148``: counts sum over all chains; a variable
collapsed in any chain uses that chain's exact marginal outright) while
splitting the *execution*:

  - ``main``: plain-caps group holding the starting
    simple chains at full ``chains_per_variant`` — the bulk of the
    sampling throughput and of the merged count estimates.
  - ``aux``: collapse-headroom group (XLA sweep, dense-256 caps — see
    ``pgm/encode.COLLAPSE_OA_DENSE_CAP``) holding every adaptively
    collapsed variant at a reduced chain count (``AUX_CHAINS``) — it
    only needs enough mixing to feed the Rao-Blackwell conditional
    snapshots and its exact marginals.

The aux group advances ``AUX_TICK_SWEEPS`` sweeps per :meth:`flush`
(the engine's scoring tick) instead of a full main window: RB snapshots
stay decorrelated between ticks without letting the slow path dominate
the tick budget (r3 advanced aux one full 2000-sweep window per tick,
which was the bulk of the 10-500x adaptive-vs-plain throughput gap).

The reference has no analogue — all its chains cost the same
(goroutines over identical scalar code, ``sampler/chain.go:197-215``);
this split exists because the two factor-graph shapes compile to sweeps
of very different cost.  Whether that gap is large enough on the GPU to
keep the split is not measured yet (ROADMAP design 2).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from grample_tpu.pgm.discrete import DiscreteModel
from grample_tpu.sampler.chains import MAX_VARIANTS, ChainGroup

#: micro-chains per collapse variant in the aux group
AUX_CHAINS = 256

#: collapse variants the aux group will hold (bounds its device arrays)
AUX_MAX_VARIANTS = 64

#: sweeps the aux group advances per engine scoring tick (see module
#: doc).  64 resamples every free var 64 times between RB snapshots —
#: ample decorrelation.  The starting value only: each flush re-sizes the
#: next aux advance to AUX_TICK_BUDGET_SECS from the measured rate, never
#: below this floor.
AUX_TICK_SWEEPS = 64

#: wall seconds of aux advance per engine tick the split group aims for
AUX_TICK_BUDGET_SECS = 3.0

def aux_caps(base_model: DiscreteModel):
    """Encode capacities for the aux (collapse) group.

    Dense-256 collapse-headroom caps (no gather-bank growth — the gather
    bank under stacked variants is the slow path), forced
    to ``rowgather`` base mode: the aux group can grow to
    ``AUX_MAX_VARIANTS`` slots, and per-slot Wbase constants at
    collapse-headroom widths cost ~100 MB each on Promedus-class nets —
    rowgather drops them entirely for a slightly slower base step on a
    group that is not the throughput path.

    The generic ``collapse_headroom`` estimate (+2 chromatic groups)
    undershoots big-blanket variants — a collapse replacement factor is
    a clique over the blanket, and e.g. Promedus_11's blanket-9 variants
    recolor 6 -> 10 groups.  Mid-run caps growth re-encodes and
    recompiles both sweep programs on the budget clock, so probe the
    widest candidate variants up front (host-side collapse + caps
    measurement, milliseconds) and merge their true requirements in.
    """
    import dataclasses

    from grample_tpu.pgm.encode import (
        COLLAPSE_OA_DENSE_CAP,
        compute_caps,
        merge_caps,
    )
    from grample_tpu.sampler.collapse import collapse_var, is_collapsible

    caps = compute_caps(
        base_model, collapse_headroom=True, slot_hint=8, headroom_factors=2,
    )
    blankets = base_model.blankets()
    sized = sorted(
        (
            (len(blankets[v]), v)
            for v in range(base_model.num_vars)
            if is_collapsible(
                base_model, v, blankets[v], oa_cap=COLLAPSE_OA_DENSE_CAP
            )
        ),
        reverse=True,
    )
    for _, v in sized[:3]:
        variant, _m = collapse_var(base_model, v)
        caps = merge_caps(
            caps, compute_caps(variant, oa_dense_cap=caps.oa_dense_cap)
        )
    return dataclasses.replace(caps, base_mode="rowgather")


def aux_group_factory(max_variants: int = MAX_VARIANTS, rb_mixture: bool = True):
    """ChainGroup factory for the aux group — shared by
    :meth:`SplitChainGroup._ensure_aux` and checkpoint resume, so a
    resumed aux group gets the exact same caps/limits as a fresh one
    (a resume that rebuilt the aux with default collapse-headroom caps
    would restore the rowgather-at-128-slots tier).
    """

    def make(model, chains_per_variant, converge_window, seed, **_kw):
        return ChainGroup(
            model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            seed=seed,
            caps=aux_caps(model),
            max_variants=min(max_variants, AUX_MAX_VARIANTS),
            rb_mixture=rb_mixture,
        )

    return make


class SplitChainGroup:
    """Duck-typed ChainGroup: plain slots on the fast path, collapse
    slots on the slow one.  See module doc."""

    #: adapt_step warm-start policy (see sampler/adaptive.py): aux
    #: collapse variants are count-weightless, only their RB overrides
    #: matter, and those need the plain ensemble's mode diversity —
    #: transplant joint states from a main slot (Promedus_19 r5 fix)
    adapt_init = "transplant"

    def __init__(
        self,
        base_model: DiscreteModel,
        chains_per_variant: int,
        converge_window: int,
        seed: int = 0,
        max_variants: int = MAX_VARIANTS,
        rb_mixture: bool = True,
        aux_chains: int = AUX_CHAINS,
        collapse_headroom: bool = True,  # accepted for factory parity
        _main: Optional[ChainGroup] = None,
        _aux: Optional[ChainGroup] = None,
    ):
        self.base = base_model
        self.cpv = int(chains_per_variant)
        self.cw = int(converge_window)
        self.seed = int(seed)
        self._max_variants = max_variants
        self.rb_mixture = bool(rb_mixture)
        self.aux_cpv = min(int(aux_chains), self.cpv)
        #: cumulative wall seconds spent advancing the aux group (the
        #: split design's overhead budget; surfaced in run results so
        #: the aux share of each tick is measured, not assumed)
        self.aux_secs = 0.0
        self.main = _main or ChainGroup(
            base_model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            seed=seed,
            collapse_headroom=False,
            rb_mixture=rb_mixture,
        )
        self.aux: Optional[ChainGroup] = _aux
        self._aux_thread = None
        # the measured-rate aux sweep count (see _advance_aux)
        self._aux_sweeps = AUX_TICK_SWEEPS

    # ---- aggregate views -------------------------------------------------
    @property
    def variants(self) -> List[DiscreteModel]:
        return self.main.variants + (self.aux.variants if self.aux else [])

    @property
    def num_variants(self) -> int:
        return self.main.num_variants + (self.aux.num_variants if self.aux else 0)

    @property
    def max_variants(self) -> int:
        """Effective variant capacity: collapse variants can only go to
        the aux group (capped at ``AUX_MAX_VARIANTS``), so the room the
        adaptive controller sees is main's live slots plus aux capacity
        (ADVICE r3: reporting the configured 128 let ``adapt_step`` add
        past the aux limit and abort the run with a RuntimeError)."""
        aux_cap = min(self._max_variants, AUX_MAX_VARIANTS)
        return min(self._max_variants, self.main.num_variants + aux_cap)

    @property
    def num_chains(self) -> int:
        return self.main.num_chains + (self.aux.num_chains if self.aux else 0)

    @property
    def total_samples(self) -> int:
        return self.main.total_samples + (self.aux.total_samples if self.aux else 0)

    @property
    def total_sweeps(self) -> int:
        return self.main.total_sweeps + (self.aux.total_sweeps if self.aux else 0)

    @property
    def slot_cap(self) -> int:
        return self.main.slot_cap + (self.aux.slot_cap if self.aux else 0)

    @property
    def collapse_oa_cap(self) -> int:
        """Candidate guard bound for adapt_step (see ChainGroup): the aux
        group's dense cap once it exists, else the collapse default."""
        if self.aux is not None:
            return self.aux.caps.oa_dense_cap
        from grample_tpu.pgm.encode import COLLAPSE_OA_DENSE_CAP

        return COLLAPSE_OA_DENSE_CAP

    def adapt_ready(self) -> bool:
        """False while the background aux build is still running: the
        engine skips that tick's adapt_step (sampling continues) rather
        than blocking on the compile."""
        th = self._aux_thread
        return th is None or not th.is_alive()

    # ---- capacity / lifecycle -------------------------------------------
    def _build_aux(self) -> ChainGroup:
        aux = aux_group_factory(
            self._max_variants, self.rb_mixture
        )(
            self.base,
            chains_per_variant=self.aux_cpv,
            converge_window=self.cw,
            seed=self.seed + 104729,
        )
        # pre-size 8 slots: the chunked advance compiles per chunk
        # shape (min(CHUNK_SLOTS, slot_cap)), so lazy pow2 growth
        # from 1 would compile chunk widths 1, 2, 4, 8 — four pairs
        # of programs on the budget clock.
        aux.reserve(8)
        return aux

    def prewarm_aux(self) -> None:
        """Build and compile the aux group during engine startup.

        An adaptive run WILL create the aux group at its first adapt
        step, and doing it there costs ~40 s of budget clock on
        Promedus-class nets (caps probe + device alloc + both sweep
        compiles).  Doing it here keeps every adapt tick cheap.
        Synchronous, so its compiles land before the sampling-budget
        clock anchors and never overlap the main loop's own."""
        self._ensure_aux()

    def join_prewarm(self) -> None:
        """Kept for engine compatibility (the aux build is synchronous
        now — nothing to wait for)."""

    def _ensure_aux(self) -> ChainGroup:
        if self.aux is None:
            aux = self._build_aux()
            aux.warmup()
            self.aux = aux
        return self.aux

    def reserve(self, n_slots: int):
        # Collapse slots live in aux and grow lazily there; main only
        # ever holds the starting plain chains, so a large engine
        # --reserve (meant for collapse variants) must not pre-size
        # full-width plain slots.  8 covers every reference start config
        # (chains default 2, experiment-rnd uses 8).
        self.main.reserve(min(n_slots, 8))

    def add_variant(self, model: DiscreteModel, burn_sweeps: int = 0,
                    warm_marginals=None, init_states=None) -> int:
        # route first, then guard against the DESTINATION group's own
        # capacity: the aggregate max_variants is capped by aux capacity,
        # which must not block plain (main-group) additions (ADVICE r4)
        v = self.base.num_vars
        newly_collapsed = bool(
            (model.collapsed[:v] & ~self.base.collapsed[:v]).any()
        )
        if newly_collapsed:
            aux = self._ensure_aux()
            if aux.num_variants >= aux.max_variants:
                raise RuntimeError(
                    f"aux variant limit {aux.max_variants} reached"
                )
            first = aux.num_variants == 0
            slot = aux.add_variant(model, burn_sweeps=burn_sweeps,
                                   warm_marginals=warm_marginals,
                                   init_states=init_states)
            if first:
                aux.warmup()  # compile the slow path off the first tick
            return self.main.num_variants + slot
        if self.main.num_variants >= self._max_variants:
            raise RuntimeError(f"variant limit {self._max_variants} reached")
        return self.main.add_variant(model, burn_sweeps=burn_sweeps,
                                     warm_marginals=warm_marginals,
                                     init_states=init_states)

    def add_variants(self, models, burn_sweeps: int = 0,
                     warm_marginals=None, init_states=None) -> list:
        """Batched adds: all-plain sets go to main in ONE batched call
        (per-variant adds restack and recompile device updates each
        time — 67 s vs 7 s for the 2 reference starting slots on
        Promedus_19, r5), all-collapse sets to aux; mixed sets fall
        back per-variant."""
        v = self.base.num_vars
        newly = [
            bool((mv.collapsed[:v] & ~self.base.collapsed[:v]).any())
            for mv in models
        ]
        if not any(newly):
            if self.main.num_variants + len(models) > self._max_variants:
                raise RuntimeError(
                    f"variant limit {self._max_variants} reached"
                )
            return self.main.add_variants(
                models, burn_sweeps=burn_sweeps,
                warm_marginals=warm_marginals, init_states=init_states,
            )
        if not all(newly):
            return [
                self.add_variant(mv, burn_sweeps, warm_marginals, init_states)
                for mv in models
            ]
        aux = self._ensure_aux()
        if aux.num_variants + len(models) > aux.max_variants:
            raise RuntimeError(f"aux variant limit {aux.max_variants} reached")
        first = aux.num_variants == 0
        slots = aux.add_variants(models, burn_sweeps=burn_sweeps,
                                 warm_marginals=warm_marginals,
                                 init_states=init_states)
        if first:
            aux.warmup()
        return [self.main.num_variants + s for s in slots]

    def warmup(self):
        self.main.warmup()
        if self.aux is not None and self.aux.slot_cap:
            self.aux.warmup()

    # ---- advancing -------------------------------------------------------
    def burn(self, sweeps: int):
        self.main.burn(sweeps)
        if self.aux is not None:
            self.aux.burn(sweeps)

    def burn_annealed(self, sweeps: int, stages: int = 0):
        from grample_tpu.sampler.chains import ANNEAL_STAGES

        stages = stages or ANNEAL_STAGES
        self.main.burn_annealed(sweeps, stages)
        if self.aux is not None:
            self.aux.burn_annealed(sweeps, stages)

    def advance(self, sweeps: Optional[int] = None, defer: bool = False) -> int:
        """Advance main; aux advances once per flush (see module doc)."""
        taken = self.main.advance(sweeps, defer=defer)
        if not defer:
            taken += self._advance_aux()
        return taken

    def _advance_aux(self) -> int:
        if self.aux is None or self.aux.num_variants == 0:
            return 0
        import time

        sweeps = min(self.cw, self._aux_sweeps)
        t0 = time.time()
        taken = self.aux.advance(sweeps, defer=False)
        dt = time.time() - t0
        self.aux_secs += dt
        # re-size the next aux advance to the tick budget from the
        # measured rate, never below the AUX_TICK_SWEEPS floor
        rate = sweeps / max(dt, 1e-6)
        self._aux_sweeps = max(
            AUX_TICK_SWEEPS, min(self.cw, int(AUX_TICK_BUDGET_SECS * rate))
        )
        return taken

    def flush(self) -> None:
        self.main.flush()
        self._advance_aux()

    def rb_accumulate(self) -> None:
        if self.aux is None or self.aux.num_variants == 0:
            return
        self.aux.rb_accumulate()
        # plain-slot donor snapshots from the full-width main group:
        # the aux variants advance AUX_TICK_SWEEPS per tick at AUX_CHAINS
        # width, so their own RB mixtures lag the live ensemble badly on
        # slow-drifting nets (Promedus_19's stuck cluster) — the main
        # slots sample the same blankets at full width and their
        # chain-count weight dominates the blend (see ChainGroup.
        # rb_accumulate_external / _rbp_accum)
        if self.main.num_variants and self.main.state is not None:
            self.aux.rb_accumulate_external(
                self.main.state, self.main.cpv,
                n_slots=self.main.num_variants,
            )

    def plain_slot_states(self) -> Optional[np.ndarray]:
        """Transplant donor states come from the full-width main group
        (see ChainGroup.plain_slot_states)."""
        return self.main.plain_slot_states()

    # ---- estimation ------------------------------------------------------
    def collapsed_any(self) -> np.ndarray:
        out = self.main.collapsed_any()
        if self.aux is not None:
            out = out | self.aux.collapsed_any()
        return out

    def merged_marginals(self) -> np.ndarray:
        merged = self.main.merged_marginals()
        if self.aux is None or self.aux.num_variants == 0:
            return merged
        aux_m = self.aux.merged_marginals()
        out = merged + aux_m
        # any-collapsed wins outright (reference MergeChains): the aux
        # group already resolved first-collapsing-variant order and RB
        # mixture overrides within aux_m's rows
        v = self.base.num_vars
        override = self.aux.collapsed_any() & ~self.base.collapsed[:v]
        out[override] = aux_m[override]
        return out

    def convergence(self, measure: str = "hellinger", merged=None) -> np.ndarray:
        """PSRF from the main group's chains (the statistical bulk);
        vars collapsed in any aux variant score 1.0 (reference
        ``ChainConvergence``, ``sampler/chain.go:86-89``)."""
        if merged is None:
            merged = self.merged_marginals()
        vals = self.main.convergence(measure=measure, merged=merged)
        if self.aux is not None:
            vals = np.where(self.aux.collapsed_any(), 1.0, vals)
        return vals
