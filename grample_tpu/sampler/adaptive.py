"""Adaptive Rao-Blackwellisation controller.

The convergence-ranked collapse policy of the reference
(``ConvergenceSampler.Adapt``, ``sampler/adaptive.go:57-157``): between
sampling windows, rank free variables by the distance-based PSRF and
spawn new chain variants in which the chosen variables are exactly
collapsed.  Differences from the reference, on purpose:

  - candidate filter uses the full collapsibility guard (blanket size
    AND replacement-table size); the reference checks only blanket size
    and would abort the run when e.g. an ObjectDetection card-16 blanket
    passes the count check but overflows the 2^23 table cap;
  - ``policy="worst"`` collapses the *worst*-converged candidates
    (highest PSRF), which is the documented intent of both the paper and
    the reference's comments; ``policy="ref-tail"`` reproduces the
    reference code's literal behavior (sort descending, then take from
    the tail — i.e. the best-converged); both are valid estimators,
    they only steer adaptation differently;
  - new variants warm-start from the current merged marginal estimate
    (``warm_start=True``) instead of uniform — the reference's
    2-sweep burn-in only makes sense with a warm start, but its fresh
    clones actually restart uniform.
"""

from __future__ import annotations

from typing import List

from grample_tpu.pgm.discrete import norm_marginals
from grample_tpu.sampler.chains import ChainGroup
from grample_tpu.sampler.collapse import collapse_var, is_collapsible

#: burn-in (sweeps) for adaptively added chains — reference adaptive.go:145
ADAPT_BURN_SWEEPS = 2


def adapt_step(
    group: ChainGroup,
    new_chain_count: int,
    measure: str = "hellinger",
    policy: str = "worst",
    warm_start: bool = True,
) -> List[int]:
    """Add up to ``new_chain_count`` collapsed variants. Returns collapsed
    variable ids (possibly empty)."""
    if group.num_variants >= group.max_variants:
        return []
    if group.num_chains < 2:
        raise ValueError("at least 2 chains required for adaptation")

    base = group.base
    merged = group.merged_marginals()
    collapsed_any = group.collapsed_any()
    blankets = base.blankets()

    oa_cap = getattr(group, "collapse_oa_cap", 0)
    candidates = [
        v
        for v in range(base.num_vars)
        if base.fixed[v] < 0
        and not collapsed_any[v]
        and len(blankets[v]) > 1
        and is_collapsible(base, v, blankets[v], oa_cap=oa_cap)
    ]
    if not candidates:
        return []

    room = group.max_variants - group.num_variants
    take = min(new_chain_count, room)
    if len(candidates) <= take:
        targets = candidates
    else:
        psrf = group.convergence(measure=measure, merged=merged)
        if policy == "worst":
            order = sorted(candidates, key=lambda v: -psrf[v])
        elif policy == "ref-tail":
            order = sorted(candidates, key=lambda v: psrf[v])
        else:
            raise ValueError(f"unknown adapt policy {policy!r}")
        targets = order[:take]

    # Warm-start policy follows the GROUP ARCHITECTURE (measured in the
    # reference-config acceptance runs, ``tools/experiments.py``):
    #
    # - "transplant" (SplitChainGroup): copy joint states from a plain
    #   slot.  Aux collapse variants are count-weightless (256 chains vs
    #   the main group's full-width slots), so ONLY their Rao-Blackwell
    #   overrides matter — and those need the plain ensemble's mode
    #   diversity: drawing each var independently from the merged
    #   marginal destroys mode correlations, the incoherent states
    #   quench into the dominant basin, and the RB blanket distribution
    #   over-concentrates (Promedus_19 r4: collapsed cluster 303-305
    #   sharpened into the wrong mode, max Hellinger 0.64 -> 0.77;
    #   transplant fixed it to 0.62 and flipped the collapsed vars to a
    #   net win).
    #
    # - "redraw" (full-width ChainGroup): draw each var independently
    #   from the current merged estimate.  Full-width collapse variants
    #   DOMINATE the merged counts (8x1024 chains vs 2x1024 plain on
    #   Grids_13), and the redraw acts as a mean-field re-equilibration:
    #   the re-initialized ensembles land closer to Boltzmann mode
    #   weights than the drifted plain slots and pull every variable's
    #   merged estimate toward truth (Grids_13 at one fixed budget: mean
    #   Hellinger 0.3057 with redraw vs 0.3751 with transplant, plain
    #   0.3766).
    warm = None
    donor = None
    if warm_start:
        policy = getattr(group, "adapt_init", "transplant")
        if policy == "transplant":
            donor = group.plain_slot_states()
        if donor is None:
            warm = norm_marginals(merged, base.cards)

    variants = [collapse_var(base, var)[0] for var in targets]
    # batched add (one device update per stack key) + one batched burn:
    # per-add paths copied every stack array per variant and ran a
    # full-group 2-sweep dispatch per add
    group.add_variants(variants, burn_sweeps=ADAPT_BURN_SWEEPS,
                       warm_marginals=warm, init_states=donor)
    return list(targets)
