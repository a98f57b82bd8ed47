"""Rao-Blackwellised variable collapse (exact marginalization).

The algorithmic heart of kelly19a, re-derived from the reference's
``GibbsCollapsed.Collapse`` (``sampler/gibbs-collapsed.go:98-314``) as a
*vectorized* host-side factor-graph transformation:

Collapsing variable v exactly integrates it out of the model:
  1. enumerate every assignment of v's Markov blanket (evidence vars
     pinned) — one [A, B] tensor, not an odometer loop;
  2. w(a) = exp( sum of incident log-factors at a ) for all assignments
     at once (bulk gather per factor);
  3. the exact conditional marginal of v given evidence is the
     scatter-sum of w by v's value; the replacement factor
     ``COLLAPSE-<name>`` over blanket∖{v} is the scatter-sum of w by
     the remaining values;
  4. every factor touching v is deleted and the replacement spliced in;
     v is flagged collapsed and thereafter never sampled — its marginal
     estimate is the exact one (variance-free, the Rao-Blackwell win).

Tractability guards match the reference: blanket (including v) at most
``NEIGHBOR_VAR_MAX`` = 12 variables, replacement table within the 2^23
entry cap, and at least one remaining variable.

This runs on the host (numpy): collapse events are rare (adaptation
cadence, seconds apart) and mutate the compiled factor graph — the
resulting model variant is re-encoded against shared shape capacities
and joins the vmapped device sweep (see pgm/encode.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from grample_tpu.pgm.discrete import (
    LOG_EPS,
    MAX_TABLE_SIZE,
    DiscreteModel,
    Factor,
    letter26,
    table_strides,
)
from grample_tpu.pgm.exact import enumerate_assignments

#: Max blanket size (including the variable itself) that may be collapsed;
#: reference ``sampler/gibbs-collapsed.go:93``.
NEIGHBOR_VAR_MAX = 12


class CollapseError(ValueError):
    pass


def is_collapsible(
    m: DiscreteModel, var: int, blanket=None, oa_cap: int = 0
) -> bool:
    """Can ``var`` be collapsed under the reference's guards?

    ``oa_cap`` (0 = off) adds the batched engine's dense-bank guard: every
    incidence of the replacement factor must fit the dense
    classification (``table_size / card <= oa_cap``), i.e. the variant
    must not need gather-bank rows.  The reference has no such guard
    (its scalar loop costs the same either way,
    ``sampler/gibbs-collapsed.go:93``); here the gather bank under
    stacked variants is the slow path, so the adaptive controller only
    builds dense-eligible variants (``pgm/encode.COLLAPSE_OA_DENSE_CAP``
    keeps every Promedus/Pedigree/Grids candidate eligible; it trims
    high-cardinality outliers like ObjectDetection's biggest blankets).
    """
    if m.fixed[var] >= 0 or m.collapsed[var]:
        return False
    b = blanket if blanket is not None else m.blankets()[var]
    if len(b) > NEIGHBOR_VAR_MAX or len(b) < 2:
        return False
    rest = [u for u in sorted(b) if u != var]
    tsize = float(np.prod(m.cards[rest], dtype=np.float64))
    if tsize > MAX_TABLE_SIZE:
        return False
    if oa_cap > 0 and any(tsize // int(m.cards[u]) > oa_cap for u in rest):
        return False
    return True


def collapsible_vars(m: DiscreteModel) -> List[int]:
    blankets = m.blankets()
    return [v for v in range(m.num_vars) if is_collapsible(m, v, blankets[v])]


def pick_random_collapsible(
    m: DiscreteModel, rng: np.random.Generator, oa_cap: int = 0
) -> Optional[int]:
    """Uniform random eligible var, retrying up to |V| times — the
    reference's ``Collapse(-1)`` selection loop (gibbs-collapsed.go:102-120)."""
    free = np.nonzero(m.free_mask)[0]
    if free.size == 0:
        return None
    blankets = m.blankets()
    for _ in range(m.num_vars):
        v = int(rng.choice(free))
        if is_collapsible(m, v, blankets[v], oa_cap=oa_cap):
            return v
    return None


def collapse_conditional(
    m: DiscreteModel, var: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact conditional P(var | blanket∖{var}) as one dense table.

    Returns ``(rest_vars [B], rest_strides [B], cond [T, card])`` where
    ``T = prod(cards[rest])``: row ``r`` is the normalized conditional of
    ``var`` given the rest-assignment with mixed-radix index ``r``.

    This is the kernel of the true Rao-Blackwell *mixture* estimator
    (see ``ChainGroup.rb_accumulate``): averaging these conditionals over
    the collapsed variant's chain samples of the blanket converges to the
    variable's true marginal.  The reference instead freezes the LOCAL
    blanket enumeration at collapse time as the marginal forever
    (``sampler/gibbs-collapsed.go:221-243``) — a static approximation
    that ignores the rest of the graph.  Rows whose rest-assignment
    conflicts with evidence are never visited by any chain (states honor
    evidence) and are left at the 1e-12 seed.
    """
    if var < 0 or var >= m.num_vars:
        raise CollapseError(f"invalid variable index {var}")
    blanket = sorted(m.blankets()[var])
    if len(blanket) > NEIGHBOR_VAR_MAX:
        raise CollapseError(
            f"blanket of var {var} has {len(blanket)} vars (> {NEIGHBOR_VAR_MAX})"
        )
    rest = [u for u in blanket if u != var]
    if not rest:
        raise CollapseError("conditional would have an empty given-set")
    rest_arr = np.array(rest, dtype=np.int64)
    tsize = int(np.prod(m.cards[rest_arr], dtype=np.float64).clip(max=2 * MAX_TABLE_SIZE))
    if tsize > MAX_TABLE_SIZE:
        raise CollapseError(f"conditional table {tsize} exceeds {MAX_TABLE_SIZE}")

    blanket_arr = np.array(blanket, dtype=np.int64)
    pos = {int(u): i for i, u in enumerate(blanket_arr)}
    assigns = enumerate_assignments(m.cards[blanket_arr], m.fixed[blanket_arr])
    logw = np.zeros(assigns.shape[0], dtype=np.float64)
    for f in m.factors:
        if var not in f.scope:
            continue
        t = f.table
        if not f.is_log:
            t = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        cols = np.array([pos[int(u)] for u in f.scope], dtype=np.int64)
        logw += t[assigns[:, cols] @ f.strides(m.cards)]
    w = np.exp(logw)

    card = int(m.cards[var])
    rest_strides = table_strides(m.cards[rest_arr])
    rest_cols = np.array([pos[int(u)] for u in rest_arr], dtype=np.int64)
    cond = np.full((tsize, card), 1e-12, dtype=np.float64)
    np.add.at(cond, (assigns[:, rest_cols] @ rest_strides, assigns[:, pos[var]]), w)
    cond /= cond.sum(axis=1, keepdims=True)
    return rest_arr, rest_strides, cond


def collapse_var(m: DiscreteModel, var: int) -> Tuple[DiscreteModel, np.ndarray]:
    """Return (new model variant with ``var`` collapsed, exact marginal).

    The input model is not mutated.  The exact marginal is the
    conditional P(var | evidence-in-blanket) accumulated over the whole
    blanket enumeration, normalized — identical semantics to the
    reference including the 1e-12 marginal seed and the log-eps factor
    floor.
    """
    if var < 0 or var >= m.num_vars:
        raise CollapseError(f"invalid variable index {var}")
    if m.fixed[var] >= 0:
        raise CollapseError(f"cannot collapse evidence-fixed var {var}")
    if m.collapsed[var]:
        raise CollapseError(f"var {var} already collapsed")

    blanket = sorted(m.blankets()[var])
    if len(blanket) > NEIGHBOR_VAR_MAX:
        raise CollapseError(
            f"blanket of var {var} has {len(blanket)} vars (> {NEIGHBOR_VAR_MAX})"
        )
    rest = [u for u in blanket if u != var]
    if not rest:
        raise CollapseError("replacement factor would have 0 variables")
    rest_arr = np.array(rest, dtype=np.int64)
    tsize = int(np.prod(m.cards[rest_arr], dtype=np.float64).clip(max=2 * MAX_TABLE_SIZE))
    if tsize > MAX_TABLE_SIZE:
        raise CollapseError(f"replacement table {tsize} exceeds {MAX_TABLE_SIZE}")

    blanket_arr = np.array(blanket, dtype=np.int64)
    pos = {int(u): i for i, u in enumerate(blanket_arr)}

    # All blanket assignments, evidence pinned (the VariableIter honorFixed
    # enumeration) — [A, B]
    assigns = enumerate_assignments(m.cards[blanket_arr], m.fixed[blanket_arr])

    # Bulk-evaluate incident factors in log space
    logw = np.zeros(assigns.shape[0], dtype=np.float64)
    incident = [f for f in m.factors if var in f.scope]
    for f in incident:
        t = f.table
        if not f.is_log:
            t = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        cols = np.array([pos[int(u)] for u in f.scope], dtype=np.int64)
        idx = assigns[:, cols] @ f.strides(m.cards)
        logw += t[idx]
    w = np.exp(logw)

    # Exact marginal of var (1e-12 seed, reference gibbs-collapsed.go:139)
    card = int(m.cards[var])
    marg = np.full(card, 1e-12, dtype=np.float64)
    np.add.at(marg, assigns[:, pos[var]], w)
    marg /= marg.sum()

    # Replacement factor over blanket∖{var}
    rest_cols = np.array([pos[int(u)] for u in rest_arr], dtype=np.int64)
    table = np.zeros(tsize, dtype=np.float64)
    idx = assigns[:, rest_cols] @ table_strides(m.cards[rest_arr])
    np.add.at(table, idx, w)

    post = Factor(name=f"COLLAPSE-{letter26(var)}", scope=rest_arr, table=table)

    out = m.clone()
    out.factors = [f.clone() for f in m.factors if var not in f.scope]
    out.factors.append(post)
    if not out.factors:
        raise CollapseError("no functions left after collapse")
    out.collapsed[var] = True
    k = out.marginals.shape[1]
    out.marginals[var, :] = 0.0
    out.marginals[var, :card] = marg
    out.check()
    return out, marg
