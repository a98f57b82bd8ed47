"""The Gibbs sweep compute path — dense XLA, matmul-shaped, scatter-free.

This is the hot loop of the whole framework: the batched successor
of the reference's ``SampleVar`` inner loop (``sampler/gibbs-simple.go:
163-271``), redesigned from per-site pointer chasing to batched tensor
ops.  Design deltas vs the reference:

  - *random scan, one site at a time*  →  *chromatic systematic sweep*:
    every variable of one color class updates simultaneously across all
    chains (conditionally independent given the rest);
  - *exp + clamp + linear-scan categorical draw*  →  *single-uniform
    inverse-CDF draw* over the max-shifted conditional (K <= 16, so the
    cumsum is a handful of vector ops and needs one uniform instead of
    K Gumbels).  The ≥1e-6 relative-probability floor that keeps the
    chain irreducible (``gibbs-simple.go:248-258``) is kept by adding
    ``1e-6 · total`` to every in-card outcome before the draw;
  - *MT19937 behind a channel* (``rand/rand.go``)  →  counter-based
    ``jax.random`` keys folded per (variant, sweep, color);
  - *per-variable ring-buffer history* (``buffer/circular.go``)  →
    incremental split-half count tensors.

Device layout: the sweep runs in the encoder's color-contiguous
permuted variable space (see ``pgm/encode.py``) with state ``[NVp, C]``
— the chain axis is the minor (contiguous) one, and every state/count
update is a contiguous ``dynamic_update_slice`` of one color block.
**No scatter exists on the hot path**: XLA cannot prove the row
updates collision-free, and a scatter would serialize them.  Per
chromatic color:

  base   = Wbase · state          (one matmul; exact — all integers)
  logits = onehot(base) · tables  (contraction over local tables)
  newv   = inverse-CDF draw       (fused elementwise chain)
  state[block], counts[block]     (contiguous slice updates)

Per-site cost is O(blanket) table work plus the base matmul; for
high-degree models where the Wbase constants would blow up, the encoder
selects a row-gather base path instead (``EncodeCaps.sweep_mode``).
Factors whose local table exceeds ``encode.OA_DENSE_CAP`` (giant
collapse replacements) use a flat-table gather bank.  The sweep count
is a *traced* scalar (``fori_loop``), so one compiled program serves
every window/burn-in size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Irreducibility floor: every outcome keeps relative probability >= 1e-6
FLOOR = 1e-6
NEG = -1e30
HIGHEST = lax.Precision.HIGHEST

_XS_KEYS = (
    "sw_scope_vars",
    "sw_other_strides",
    "sw_local_tables",
    "gb_offset",
    "gb_self_stride",
    "gb_scope_vars",
    "gb_scope_strides",
    "gb_mask",
    "sw_kmask",
)


def _color_logits(state_p, tables, xs, wbase=None):
    """Unmasked log-conditionals of one chromatic group: [G, K, C].

    state_p: [NVp, C] float32 (permuted layout, values are exact small
    ints).  Dense bank: base indices via the Wbase matmul (exact:
    local strides <= 1024, state <= 15, all < 2^24 in f32 HIGHEST) or
    int32-exact row-gathers, then a one-hot × local-table contraction.
    Gather bank (static skip when the caps hold no gather factors):
    flat-table gather with int32 index arithmetic.  Padded dense slots
    hold all-zero local tables (contribute log 1 = 0 additively); padded
    gather slots are masked.
    """
    (scope_vars, other_strides, local_tab,
     gb_offset, gb_self_stride, gb_scope_vars, gb_scope_strides, gb_mask,
     kmask) = xs
    c = state_p.shape[1]
    kdim = local_tab.shape[-1]
    oa = local_tab.shape[-2]
    g, f = scope_vars.shape[:2]

    # ---- dense bank (statically absent in all-gather mode: F == 0) --------
    if f == 0:
        logits = jnp.zeros((g, kdim, c), dtype=jnp.float32)
    else:
        if wbase is not None:
            if oa <= 256:
                # all quantities are integers <= 256: exact in bf16 with
                # f32 accumulation (chip_smoke.py checks this on the card),
                # and a bf16 product is the cheapest exact one
                base = jnp.einsum(
                    "rv,vc->rc",
                    wbase.astype(jnp.bfloat16),
                    state_p.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32,
                ).reshape(g, f, c)
            else:
                base = jnp.einsum(
                    "rv,vc->rc",
                    wbase,
                    state_p,
                    precision=HIGHEST,
                    preferred_element_type=jnp.float32,
                ).reshape(g, f, c)
        else:
            rows = jnp.take(state_p, scope_vars.reshape(-1), axis=0)
            rows = rows.reshape(g, f, -1, c)  # [G, F, S, C]
            base = (rows * other_strides[..., None].astype(rows.dtype)).sum(axis=2)
        onehot = (
            base[:, :, None, :]
            == jnp.arange(oa, dtype=base.dtype)[None, None, :, None]
        )  # [G, F, OA, C] — exact 0/1; contraction over (f, oa).
        logits = jnp.einsum(
            "gfok,gfoc->gkc",
            local_tab,
            onehot.astype(jnp.float32),
            precision=HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [G, K, C]

    # ---- gather bank (static skip when the caps hold no gather factors) ---
    if gb_offset.shape[-1] > 0:
        rows2 = jnp.take(state_p, gb_scope_vars.reshape(-1), axis=0)
        rows2 = rows2.reshape(gb_scope_vars.shape + (c,)).astype(jnp.int32)
        # full-table strides reach 2^23: int32 arithmetic, never float
        base2 = gb_offset[..., None] + (rows2 * gb_scope_strides[..., None]).sum(axis=2)
        idx = (
            base2[:, :, None, :]
            + jnp.arange(kdim, dtype=jnp.int32)[None, None, :, None]
            * gb_self_stride[:, :, None, None]
        )  # [G, Fg, K, C]
        ent = jnp.take(tables, idx, mode="clip")
        logits = logits + (ent * gb_mask[:, :, None, None]).sum(axis=1)

    return logits


def _sample_color(state_p, tables, xs, ckey, wbase=None):
    """Resample one chromatic group's vars across all chains: [G, C] f32.

    Inverse-CDF categorical draw from the floored conditional.  All-
    padding groups (kmask false everywhere) deterministically yield 0,
    written to dead rows.
    """
    kmask = xs[-1]
    logits = _color_logits(state_p, tables, xs, wbase)  # [G, K, C]
    km = kmask[:, :, None]
    logits = jnp.where(km, logits, NEG)
    mx = logits.max(axis=1, keepdims=True)
    p = jnp.exp(logits - mx)
    # irreducibility floor (reference gibbs-simple.go:248-258): every
    # valid outcome keeps >= 1e-6 relative probability
    p = p + p.sum(axis=1, keepdims=True) * FLOOR
    p = jnp.where(km, p, 0.0)
    cdf = jnp.cumsum(p, axis=1)
    u = jax.random.uniform(ckey, (p.shape[0], 1, p.shape[2]), dtype=p.dtype)
    u = u * cdf[:, -1:, :]
    return (u > cdf).sum(axis=1).astype(jnp.float32)  # [G, C]


def _advance_one(enc, state, halves, key, num_sweeps, half_point, count: bool):
    """Advance one variant's chains by ``num_sweeps`` full chromatic sweeps.

    state:  [C, V+1] int32 (old var order; permuted into [NVp, C] f32
            inside, converted back at the end)
    halves: [2, C, V+1, K] float32 — split-half window counts are ADDED
            to the incoming buffer (count=True)
    num_sweeps / half_point: traced int scalars (no recompiles per size).
    """
    kdim = halves.shape[-1]
    nc, g = enc["sw_kmask"].shape[:2]
    c = state.shape[0]
    tables = enc["tables"]
    wbase = enc.get("sw_wbase")
    xs_colors = [tuple(enc[k][ci] for k in _XS_KEYS) for ci in range(nc)]
    kiota = jnp.arange(kdim, dtype=jnp.float32)

    state_p = jnp.take(state.T, enc["old_of_new"], axis=0).astype(jnp.float32)

    def run_colors(state_p, counts, skey, hsel):
        for ci in range(nc):
            wb = None if wbase is None else wbase[ci]
            newv = _sample_color(
                state_p, tables, xs_colors[ci], jax.random.fold_in(skey, ci), wb
            )
            state_p = lax.dynamic_update_slice(state_p, newv, (ci * g, 0))
            if count:
                ok = (newv[:, None, :] == kiota[None, :, None]).astype(counts.dtype)
                blk = lax.dynamic_slice(
                    counts, (hsel, ci * g, 0, 0), (1, g, kdim, c)
                )
                counts = lax.dynamic_update_slice(
                    counts, blk + ok[None], (hsel, ci * g, 0, 0)
                )
        return state_p, counts

    if count:
        # the `+ halves[...]*0` term makes the accumulator inherit the
        # shard_map varying-axes annotation (a plain zeros literal would
        # be replicated and break the fori_loop carry type)
        counts = (
            jnp.zeros((2, nc * g + 1, kdim, c), dtype=halves.dtype)
            + halves[0, 0, 0, 0] * 0
        )

        def sweep_body(si, carry):
            state_p, counts = carry
            skey = jax.random.fold_in(key, si)
            hsel = (si >= half_point).astype(jnp.int32)
            return run_colors(state_p, counts, skey, hsel)

        state_p, counts = lax.fori_loop(
            0, num_sweeps, sweep_body, (state_p, counts)
        )
        # map color-major slot counts back to the old variable order;
        # ungrouped vars (evidence/collapsed) read the never-written zero row
        mapped = jnp.take(counts, enc["slot_of_old"], axis=1)  # [2, V+1, K, C]
        halves = halves + mapped.transpose(0, 3, 1, 2)
    else:

        def sweep_body(si, state_p):
            skey = jax.random.fold_in(key, si)
            return run_colors(state_p, None, skey, 0)[0]

        state_p = lax.fori_loop(0, num_sweeps, sweep_body, state_p)

    state_out = jnp.take(state_p, enc["new_of_old"], axis=0).astype(jnp.int32).T
    return state_out, halves


@partial(jax.jit, static_argnames=("count",), donate_argnums=(1, 2))
def advance_chains(enc, state, halves, key, num_sweeps, half_point, count: bool = True):
    """Advance all variants: the vectorized AdvanceChain.

    enc:    dict of stacked arrays, leading axis N (variants)
    state:  [N, C, V+1] int32
    halves: [N, 2, C, V+1, K] float32 (donated; zero before the window)
    key:    single PRNG key; folded per variant.

    The reference spawns one goroutine per chain and joins on a WaitGroup
    (``sampler/chain.go:197-215``); here "all chains advance in parallel"
    is a single device program over the (variant, chain) batch axes.
    ``num_sweeps``/``half_point`` are traced: one compile per model shape.
    """
    n = state.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    fn = partial(_advance_one, count=count)
    return jax.vmap(fn, in_axes=(0, 0, 0, 0, None, None))(
        enc, state, halves, keys, num_sweeps, half_point
    )


def _conditional_logits(enc, state, vs, kdim: int):
    """Log-conditionals for vars ``vs`` given current state, all chains.

    Reference-shaped gather path over the var-major adjacency
    (``EncodedModel.legacy_arrays()``) — kept for exact cross-checks
    against brute-force factor evaluation; the sweep itself uses the
    color-major path above.

    state: [C, V+1] int32; vs: [G] int32 → logits [C, G, kdim] float32.
    """
    off = jnp.take(enc["adj_offset"], vs, axis=0)  # [G, F]
    sstr = jnp.take(enc["adj_self_stride"], vs, axis=0)  # [G, F]
    amask = jnp.take(enc["adj_mask"], vs, axis=0)  # [G, F]
    svars = jnp.take(enc["adj_scope_vars"], vs, axis=0)  # [G, F, S]
    sstrides = jnp.take(enc["adj_scope_strides"], vs, axis=0)  # [G, F, S]

    vals = jnp.take(state, svars, axis=1)  # [C, G, F, S]
    base = off[None] + (vals * sstrides[None]).sum(axis=-1)  # [C, G, F]

    ks = jnp.arange(kdim, dtype=jnp.int32)
    idx = base[..., None] + ks[None, None, None, :] * sstr[None, :, :, None]
    ent = jnp.take(enc["tables"], idx, mode="clip")  # [C, G, F, K]
    logits = (ent * amask[None, :, :, None]).sum(axis=2)  # [C, G, K]
    return logits


@partial(jax.jit, static_argnames=("num_chains", "kdim"))
def init_state(enc, key, num_chains: int, kdim: int, warm_marginals=None):
    """Initial chain states for all variants: [N, C, V+1] int32.

    Free vars start uniform (reference ``NewGibbsSimple``,
    ``gibbs-simple.go:101-112``); fixed vars at their evidence value.
    With ``warm_marginals`` ([N, V+1, K] probabilities) free vars are
    instead drawn from the current marginal estimate — the reference's
    warm restart after factor-graph surgery (``FunctionsChanged``,
    ``gibbs-simple.go:131-142``).
    """
    n = enc["cards"].shape[0]

    def one(cards, fixedv, key_i, warm_i):
        v1 = cards.shape[0]
        valid = jnp.arange(kdim)[None, :] < cards[:, None]  # [V+1, K]
        if warm_i is None:
            logits = jnp.where(valid, 0.0, NEG)
        else:
            logits = jnp.where(valid, jnp.log(jnp.maximum(warm_i, 1e-12)), NEG)
        gum = jax.random.gumbel(key_i, (num_chains, v1, kdim), dtype=jnp.float32)
        draw = jnp.argmax(logits[None] + gum, axis=-1).astype(jnp.int32)
        return jnp.where(fixedv[None, :] >= 0, fixedv[None, :], draw)

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    if warm_marginals is None:
        return jax.vmap(lambda c, f, k: one(c, f, k, None))(
            enc["cards"], enc["fixed"], keys
        )
    return jax.vmap(one)(enc["cards"], enc["fixed"], keys, warm_marginals)
