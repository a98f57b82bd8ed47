"""Chain runtime: batched chains over stacked collapse variants.

The reference's ``Chain`` owns one model clone + sampler + ring-buffer
history and advances in its own goroutine (``sampler/chain.go``).  Here
the unit of parallelism is inverted for the accelerator: ONE device program
advances every chain of every model variant at once —

  - variant slot axis  [N]: distinct factor graphs (base model, plus one
    slot per adaptively collapsed variable — the reference's "chain"),
  - micro-chain axis   [C]: independent chains per variant (the
    vectorization the reference lacks entirely),

with state ``[N, C, V+1]`` and split-half window counts ``[N, 2, C,
V+1, K]`` resident on device.  Slot capacity grows in powers of two so
recompiles happen O(log MaxChains) times per run, never per adapt step.

``MergeChains`` (``chain.go:96-148``) becomes a host-side reduction of
per-slot count totals, with the reference's exact semantics: a variable
collapsed in ANY variant uses that variant's exact (Rao-Blackwellised)
marginal outright; every chain contributes its uniform-initialized
marginal (1/card per entry) plus its counts.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from grample_tpu.metrics.psrf import chain_convergence
from grample_tpu.ops.gibbs_xla import advance_chains
from grample_tpu.pgm.discrete import DiscreteModel
from grample_tpu.pgm.encode import (
    EncodeCaps,
    EncodedModel,
    compute_caps,
    encode_model,
    merge_caps,
    stack_variants,
)

MAX_VARIANTS = 128  # reference ConvergenceSampler.MaxChains (adaptive.go:49)

#: Default tempered burn-in stages (see :meth:`ChainGroup.burn_annealed`).
ANNEAL_STAGES = 20

#: Variant slots advance in fixed-size chunks: ONE compiled program (the
#: chunk shape never changes) while inactive reserved slots cost nothing —
#: r1 advanced the full padded slot capacity every window, so a freshly
#: started adaptive run with 2 of 128 reserved slots burned 64x the
#: needed compute (and its burn-in blew the whole time budget).
CHUNK_SLOTS = 8

#: Minimum RB-mixture snapshots before the mixture average replaces the
#: static collapse marginal in ``merged_marginals``: a 1-snapshot average
#: is a single (correlated-chain) draw of the blanket distribution and
#: can be noisier than the static enumeration it supersedes.  Collapse
#: variants added near the end of a budget accrue few snapshots (r4:
#: Promedus_19's last adapt landed 4 variants ~40 s before the stop),
#: so the gate keeps the reference-faithful static value until the
#: mixture has at least a couple of decorrelated snapshots.
RB_MIN_SNAPSHOTS = 2

#: Per-snapshot decay of the RB mixture's running sums (both the
#: snapshot-probability sum and its weight decay by this factor before
#: each new snapshot lands).  On quasi-deterministic nets the chain
#: ensemble DRIFTS toward the true mode weights for the whole run
#: (Promedus_19's stuck clusters, Grids_13; ``tools/drift.py`` measures
#: it), so an equal-weight mixture average lags
#: the live ensemble exactly like the raw cumulative counts do; the
#: decayed mixture tracks the current — strictly better — ensemble
#: state at a small variance cost (effective window ≈ 1/(1-γ) ≈ 6-7
#: snapshots, each averaging the group's full chain width).  γ = 1
#: would restore the equal-weight average.
RB_DECAY = 0.85

#: Counted windows run in sub-windows of at most this many sweeps, so
#: no single device program runs a long counted loop.  Sub-windows keep
#: split-half semantics bit-exact: each sub-call adds into the same
#: halves buffer with the traced half_point shifted by the sweeps
#: already taken.  One extra dispatch per 256 sweeps.  Whether the
#: split still earns its place on the GPU is open (ROADMAP design 3).
XLA_MAX_COUNTED_SWEEPS = 256


@jax.jit
def _rb_indices(state, slots, rest, strides):
    """Mixed-radix blanket indices for the RB mixture, one program for
    every snapshot (slot, var) pair: state [N, C, V+1], slots [n], rest/
    strides [n, B] (sentinel-padded, stride 0) → idx [n, C] int32.

    One fused gather straight to [n, C, B]: the earlier ``state[slots]``
    form materialized an [n, C, V+1] intermediate — ~0.5 GB once
    plain-slot donor rows joined the pair list."""
    c = state.shape[1]
    g = state[
        slots[:, None, None], jnp.arange(c)[None, :, None], rest[:, None, :]
    ]  # [n, C, B]
    return (g * strides[:, None, :]).sum(axis=2)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ChainGroup:
    """All chains of a run: stacked variants × micro-chains on device."""

    #: adapt_step warm-start policy (see sampler/adaptive.py): full-width
    #: collapse variants dominate merged counts, and the independent
    #: redraw acts as a mean-field re-equilibration that beats inheriting
    #: the drifted plain ensemble (Grids_13 r5 measurement)
    adapt_init = "redraw"

    def __init__(
        self,
        base_model: DiscreteModel,
        chains_per_variant: int,
        converge_window: int,
        seed: int = 0,
        caps: Optional[EncodeCaps] = None,
        group_cap: int = 0,
        max_variants: int = MAX_VARIANTS,
        collapse_headroom: bool = False,
        rb_mixture: bool = True,
    ):
        base_model.check()
        self.base = base_model
        self.cpv = int(chains_per_variant)
        self.cw = int(converge_window)
        self.seed = int(seed)
        self.max_variants = max_variants
        self.caps = caps or compute_caps(
            base_model,
            group_cap=group_cap,
            collapse_headroom=collapse_headroom,
            slot_hint=max_variants if collapse_headroom else 1,
            # plain groups never mutate the factor graph: spare factor
            # slots would only pad the base matmul/select loops (~29%
            # dead FLOPs on Grids); growth stays lazy if a variant ever
            # needs more
            headroom_factors=2 if collapse_headroom else 0,
        )
        # rbg: counter-based bits, deterministic per seed on one backend
        # (the sweep draws one uniform per site).  The bits differ between
        # backends, so draws are never compared across CPU and GPU.
        self.key = jax.random.key(seed, impl="rbg")
        self._step = 0

        self.variants: List[DiscreteModel] = []
        self.encs: List[EncodedModel] = []
        self.slot_cap = 0
        self.stack = None  # device dict [Ncap, ...]
        self.state = None  # [Ncap, C, V+1] int32
        self.halves = None  # [Ncap, 2, C, V+1, K] float32
        self.totals: Optional[np.ndarray] = None  # host f64 [Ncap, V+1, K]
        self.total_samples = 0  # counted site updates across all chains
        self.total_sweeps = 0
        # deferred window deltas: (device [Ncap, V+1, K] int32, n_active)
        # pairs not yet folded into ``totals`` — lets the engine dispatch
        # many advance windows without a host sync per window
        self._pending: List[tuple] = []
        # Rao-Blackwell mixture state for collapsed vars, keyed (slot, var):
        # cached conditional tables (keyed by var — the base-model
        # conditional is slot-independent), and running sums of snapshot
        # estimates from each collapsing variant's own chains
        self.rb_mixture = bool(rb_mixture)
        self._rb_cond: dict = {}
        self._rb_sum: dict = {}
        self._rb_n: dict = {}  # decayed effective-snapshot weight (float)
        self._rb_count: dict = {}  # undecayed snapshot count (gate)
        # plain-slot donor snapshots, keyed by var: base-model chains
        # (full width, fast path) also sample every collapsed var's
        # blanket, so averaging the exact base conditional over THEIR
        # states is an equally valid RB mixture — and it tracks the
        # live ensemble instead of a reduced-width collapse variant
        # (r5: Promedus_19 aux estimates lagged the main drift and
        # any-collapsed-wins locked the worse value in).  Sums are
        # chain-count weighted so wide donors dominate narrow ones.
        self._rbp_sum: dict = {}
        self._rbp_w: dict = {}
        self._rbp_snaps: dict = {}

    # ---- capacity management --------------------------------------------
    @property
    def num_variants(self) -> int:
        return len(self.variants)

    @property
    def num_chains(self) -> int:
        return self.num_variants * self.cpv

    @property
    def v1(self) -> int:
        return self.caps.num_vars + 1

    @property
    def collapse_oa_cap(self) -> int:
        """Dense-classification bound a collapse variant must satisfy to
        join this group (the adaptive candidate guard passes it to
        ``is_collapsible``): variants needing gather-bank rows are
        excluded — the gather bank under stacked variants is the slow
        path."""
        return self.caps.oa_dense_cap

    @property
    def kdim(self) -> int:
        return self.caps.max_card

    def _next_key(self):
        self._step += 1
        return jax.random.fold_in(self.key, self._step)

    def _encode_grown(self, model: DiscreteModel) -> tuple:
        """encode_model with caps growth; returns (enc, grew).

        Growth re-encodes every existing variant against the merged caps
        but does NOT restack device arrays — callers that are not already
        inside a restack must do that themselves (``_encode``).
        """
        try:
            return encode_model(model, self.caps), False
        except ValueError:
            self.caps = merge_caps(
                self.caps,
                compute_caps(model, oa_dense_cap=self.caps.oa_dense_cap),
            )
            self.encs = [encode_model(mv, self.caps) for mv in self.variants]
            return encode_model(model, self.caps), True

    def _encode(self, model: DiscreteModel) -> EncodedModel:
        """Encode against shared caps, growing caps (and re-encoding all
        existing variants) if the new variant doesn't fit."""
        enc, grew = self._encode_grown(model)
        if grew:
            self._restack()
        return enc

    def _host_init_state(
        self, enc: EncodedModel, warm_marginals: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Initial [C, V+1] states on the host (no device compile).

        Free vars uniform (or drawn from ``warm_marginals`` [V(+1), K] —
        the warm restart for adaptively added chains); evidence pinned.
        """
        rng = np.random.default_rng(self._step * 7919 + 13)
        self._step += 1
        cards = np.asarray(enc.cards, dtype=np.int64)  # [V+1]
        v1 = cards.size
        if warm_marginals is None:
            u = rng.random((self.cpv, v1))
            draw = np.floor(u * cards[None, :]).astype(np.int32)
        else:
            k = self.kdim
            probs = np.zeros((v1, k), dtype=np.float64)
            probs[: warm_marginals.shape[0], : warm_marginals.shape[1]] = warm_marginals
            valid = np.arange(k)[None, :] < cards[:, None]
            probs = np.where(valid, np.maximum(probs, 1e-12), 0.0)
            probs /= probs.sum(axis=1, keepdims=True)
            cdf = np.cumsum(probs, axis=1)  # [V+1, K]
            u = rng.random((self.cpv, v1, 1))
            draw = (u > cdf[None]).sum(axis=2).astype(np.int32)
            draw = np.minimum(draw, (cards - 1)[None, :]).astype(np.int32)
        fixedv = np.asarray(enc.fixed, dtype=np.int32)
        return np.where(fixedv[None, :] >= 0, fixedv[None, :], draw)

    def _transplant_states(
        self, enc: EncodedModel, rows: np.ndarray
    ) -> np.ndarray:
        """[cpv, V+1] initial states subsampled from donor chain states.

        Donor rows are exchangeable (independent chains), so a uniform
        without-replacement subsample preserves their joint distribution;
        evidence is re-pinned defensively (donors already honor it).
        """
        if rows.ndim != 2 or rows.shape[1] != self.v1:
            raise ValueError(f"init_states shape {rows.shape} != (M, {self.v1})")
        rng = np.random.default_rng(self._step * 7919 + 13)
        self._step += 1
        if rows.shape[0] < self.cpv:
            pick = rng.integers(0, rows.shape[0], size=self.cpv)
        elif rows.shape[0] > self.cpv:
            pick = rng.choice(rows.shape[0], size=self.cpv, replace=False)
        else:
            pick = np.arange(self.cpv)
        st = rows[pick].astype(np.int32)
        fixedv = np.asarray(enc.fixed, dtype=np.int32)
        return np.where(fixedv[None, :] >= 0, fixedv[None, :], st)

    def plain_slot_states(self) -> Optional[np.ndarray]:
        """Host copy [cpv, V+1] of the first base-model (plain) slot's
        chain states — the transplant donor for adaptively added collapse
        variants (see ``add_variant``).  None when no plain slot exists
        (e.g. rnd mode collapses every starting slot)."""
        v = self.caps.num_vars
        base_col = self.base.collapsed[:v]
        for slot, mv in enumerate(self.variants):
            if not (mv.collapsed[:v] & ~base_col).any():
                return np.asarray(self.state[slot])
        return None

    def _alloc_halves(self):
        """Window count buffer (subclasses allocate it sharded)."""
        return jnp.zeros(
            (self.slot_cap, 2, self.cpv, self.v1, self.kdim), dtype=jnp.float32
        )

    def reserve(self, n_slots: int):
        """Pre-size slot capacity to avoid intermediate restacks/compiles."""
        cap = _next_pow2(max(1, n_slots))
        if cap > self.slot_cap:
            self._restack(cap)

    def _restack(self, new_slot_cap: Optional[int] = None):
        """Rebuild stacked device arrays, preserving live slot state."""
        self.flush()  # pending deltas are shaped for the OLD slot capacity
        if new_slot_cap is not None:
            self.slot_cap = new_slot_cap
        if self.slot_cap == 0:
            return
        # the base-model encode must also recover by growing caps — this
        # path (reserve → restack before any add_variant) bypassed
        # _encode's recovery in r2 and crashed the Promedus_19 bench
        base_enc = self.encs[0] if self.encs else self._encode_grown(self.base)[0]
        padded = list(self.encs) + [base_enc] * (self.slot_cap - len(self.encs))
        stack_np = stack_variants(padded[: self.slot_cap])
        self.stack = {k: jnp.asarray(v) for k, v in stack_np.items()}

        old = None if self.state is None else np.asarray(self.state)
        new_state = np.stack(
            [
                self._host_init_state(padded[i])
                for i in range(self.slot_cap)
            ]
        )
        if old is not None:
            n = min(old.shape[0], self.slot_cap)
            new_state[:n, :, :] = old[:n, :, :]
        self.state = jnp.asarray(new_state)
        self.halves = self._alloc_halves()
        old_tot = self.totals
        self.totals = np.zeros((self.slot_cap, self.v1, self.kdim), dtype=np.float64)
        if old_tot is not None:
            n = min(old_tot.shape[0], self.slot_cap)
            self.totals[:n, :, : old_tot.shape[2]] = old_tot[:n]

    def add_variant(
        self,
        model: DiscreteModel,
        burn_sweeps: int = 0,
        warm_marginals: Optional[np.ndarray] = None,
        init_states: Optional[np.ndarray] = None,
    ) -> int:
        """Add a model variant (a logical chain); returns its slot index.

        ``init_states`` [M, V+1] transplants the slot's initial chain
        states from existing equilibrated chains (rows subsampled without
        replacement when M > chains_per_variant).  This is the preferred
        warm start for adaptively collapsed variants: base-joint samples
        ARE equilibrium samples of the collapsed model's joint over the
        remaining vars, so the new variant starts in equilibrium with the
        plain ensemble's full mode diversity.  ``warm_marginals`` [V, K]
        instead draws each var INDEPENDENTLY from the merged estimate —
        which destroys mode correlations: on multimodal nets the
        incoherent states quench into the dominant mode and the variant's
        Rao-Blackwell blanket distribution over-concentrates (r4:
        Promedus_19's collapsed cluster 303-305 sharpened to the wrong
        mode, max Hellinger 0.64 -> 0.77).  ``burn_sweeps`` runs
        uncounted sweeps afterwards (reference burnIn).
        """
        if self.num_variants >= self.max_variants:
            raise RuntimeError(f"variant limit {self.max_variants} reached")
        enc = self._encode(model)
        slot = len(self.variants)
        self.variants.append(model)
        self.encs.append(enc)
        if slot >= self.slot_cap:
            self._restack(_next_pow2(slot + 1))
        else:
            # refresh the one changed slot on device
            arrays = enc.arrays()
            self.stack = {
                k: self.stack[k].at[slot].set(jnp.asarray(v))
                for k, v in arrays.items()
            }
        # (re)initialize this slot's chains on the host
        if init_states is not None:
            st = self._transplant_states(enc, np.asarray(init_states))
        else:
            st = self._host_init_state(enc, warm_marginals)
        self.state = self.state.at[slot].set(jnp.asarray(st))
        self.totals[slot] = 0.0
        if burn_sweeps > 0:
            self.burn(burn_sweeps)
        return slot

    def add_variants(
        self,
        models: List[DiscreteModel],
        burn_sweeps: int = 0,
        warm_marginals: Optional[np.ndarray] = None,
        init_states: Optional[np.ndarray] = None,
    ) -> List[int]:
        """Batched :meth:`add_variant`: ONE device update per stack key
        for the whole add set.  Per-add ``.at[slot].set`` copies every
        [Ncap, ...] stack array per variant — an adapt step adding 4
        variants paid 4 full-stack device copies (hundreds of MB on
        reserved Grids-class groups) where one suffices."""
        if not models:
            return []
        if len(models) == 1:
            return [
                self.add_variant(models[0], burn_sweeps, warm_marginals,
                                 init_states)
            ]
        if self.num_variants + len(models) > self.max_variants:
            raise RuntimeError(f"variant limit {self.max_variants} reached")
        grew_any = False
        new_encs: List[EncodedModel] = []
        for mv in models:
            enc, grew = self._encode_grown(mv)
            if grew:
                grew_any = True
                # earlier batch members were encoded under the old caps
                new_encs = [
                    encode_model(m2, self.caps)
                    for m2 in models[: len(new_encs)]
                ]
            new_encs.append(enc)
        slot0 = len(self.variants)
        slots = list(range(slot0, slot0 + len(models)))
        self.variants.extend(models)
        self.encs.extend(new_encs)
        if grew_any or slots[-1] >= self.slot_cap:
            self._restack(_next_pow2(slots[-1] + 1))
        else:
            idx = jnp.asarray(np.array(slots, dtype=np.int32))
            per_key = {}
            for enc in new_encs:
                for k2, v2 in enc.arrays().items():
                    per_key.setdefault(k2, []).append(v2)
            self.stack = {
                k2: self.stack[k2].at[idx].set(
                    jnp.asarray(np.stack(per_key[k2]))
                )
                for k2 in self.stack
            }
        st = np.stack([
            self._transplant_states(enc, np.asarray(init_states))
            if init_states is not None
            else self._host_init_state(enc, warm_marginals)
            for enc in new_encs
        ])
        idx = jnp.asarray(np.array(slots, dtype=np.int32))
        self.state = self.state.at[idx].set(jnp.asarray(st))
        self.totals[slots] = 0.0
        if burn_sweeps > 0:
            self.burn(burn_sweeps)
        return slots

    # ---- advancing -------------------------------------------------------
    def _chain_mask(self) -> np.ndarray:
        m = np.zeros(self.slot_cap, dtype=bool)
        m[: self.num_variants] = True
        return m

    def _advance_fn(self, sweeps: int, half: int, count: bool):
        """Advance the ACTIVE slot prefix, chunked (see CHUNK_SLOTS)."""
        chunk = min(CHUNK_SLOTS, self.slot_cap)
        active = max(1, self.num_variants)
        p = ((active + chunk - 1) // chunk) * chunk
        key = self._next_key()
        states, halves = [], []
        for c0 in range(0, p, chunk):
            sl = slice(c0, c0 + chunk)
            st, hv = advance_chains(
                {k: v[sl] for k, v in self.stack.items()},
                self.state[sl],
                self.halves[sl],
                jax.random.fold_in(key, c0),
                sweeps,
                half,
                count=count,
            )
            states.append(st)
            halves.append(hv)
        if p < self.slot_cap:
            states.append(self.state[p:])
            halves.append(self.halves[p:])
        self.state = jnp.concatenate(states) if len(states) > 1 else states[0]
        self.halves = jnp.concatenate(halves) if len(halves) > 1 else halves[0]

    def warmup(self):
        """Compile AND first-execute both sweep programs, side-effect free.

        Sweep counts are traced, so these two compiles serve every window
        and burn-in size.  Engines call it before anchoring time budgets:
        a cold compile can take minutes, and the first *execution* of a
        program carries a one-time cost too — so run one real sweep of
        each program, force a host sync, then restore the exact prior
        state/window/RNG (bit-exact neutrality).
        """
        if self.slot_cap == 0:
            return
        step = self._step
        state_h = np.asarray(self.state)
        halves_h = np.asarray(self.halves)
        self._advance_fn(1, 0, count=True)
        self._advance_fn(1, 1, count=False)
        np.asarray(self.halves)  # sync: wait out first-run overheads
        self.state = jnp.asarray(state_h)
        self.halves = jnp.asarray(halves_h)
        self._step = step

    def burn(self, sweeps: int):
        """Uncounted sweeps for all chains (burn-in)."""
        if sweeps <= 0 or self.slot_cap == 0:
            return
        self._advance_fn(int(sweeps), int(sweeps), count=False)
        self.total_sweeps += sweeps

    def burn_annealed(self, sweeps: int, stages: int = ANNEAL_STAGES):
        """Tempered burn-in: β ramps 1/stages → 1 over equal sweep blocks.

        Gibbs quenches on near-deterministic models (the UAI grids): from
        uniform init each chain freezes into a local mode within a few
        sweeps and the chain-ensemble marginal plateaus at the *quench
        measure* — deeper burn-in does not move it (measured on Grids_13:
        mean Hellinger 0.443 after a 100-sweep burn and still 0.438 after
        32000).  Ramping the log-potentials (tables × β) instead lets the
        ensemble re-equilibrate while the landscape sharpens, landing
        mode weights near Boltzmann: 0.368 on the same 2000-sweep budget.
        The β=1 stationary chain is untouched — this is purely an
        initialization policy, replacing the reference's uniform-init
        quench (``sampler/gibbs-simple.go:101-112``).  Works identically
        on the sharded group: the scaled stacks inherit the originals'
        shardings.
        """
        if sweeps <= 0 or self.slot_cap == 0:
            return
        stages = max(1, min(int(stages), int(sweeps)))
        per = sweeps // stages
        stack0 = self.stack
        try:
            for i in range(stages):
                beta = (i + 1.0) / stages
                n = per + (sweeps - per * stages if i == stages - 1 else 0)
                if beta < 1.0:
                    # scale only log-potential tables; strides/masks/maps
                    # are structural
                    self.stack = {
                        k: (v * beta if k in ("tables", "sw_local_tables") else v)
                        for k, v in stack0.items()
                    }
                else:
                    self.stack = stack0
                self.burn(n)
        finally:
            self.stack = stack0

    def advance(self, sweeps: Optional[int] = None, defer: bool = False) -> int:
        """Advance all chains one convergence window (counted).

        Resets and refills the split-half window tensors, adds the window
        counts into the running totals, and returns site updates taken.
        ``sweeps=0`` is a warmup: it compiles the counted-window program
        (num_sweeps is traced, so the compile serves every window size)
        without advancing anything.

        ``defer=True`` leaves the window's count delta ON DEVICE
        (``flush`` folds it into the host totals later): the engine can
        dispatch many windows back-to-back with zero host syncs between
        them — r2's engine converted <3% of raw sweep speed into counted
        samples because every window ended in a blocking host reduction.
        The count delta is summed as int32 on device (counts are exact
        integers; a window total per (slot, var, value) is ≤ cw·C ≪ 2³¹,
        where an f32 sum would lose exactness past 2²⁴).
        """
        sweeps = self.cw if sweeps is None else int(sweeps)
        self.halves = jnp.zeros_like(self.halves)
        if sweeps == 0:
            # sweeps=0 still dispatches once: the documented warmup
            # contract (compile the counted program) must hold on the
            # sub-windowed path too, whose loop body would otherwise
            # never run
            self._advance_fn(sweeps, sweeps // 2, count=True)
        else:
            # sub-windowed counted advance (see XLA_MAX_COUNTED_SWEEPS);
            # half_point shifts per sub-call so hsel stays globally exact
            done = 0
            while done < sweeps:
                sub = min(XLA_MAX_COUNTED_SWEEPS, sweeps - done)
                self._advance_fn(sub, sweeps // 2 - done, count=True)
                done += sub
        delta = self.halves.astype(jnp.int32).sum(axis=(1, 2))
        self._pending.append((delta, self.num_variants))
        self.total_sweeps += sweeps
        # counted sites are deterministic: every grouped (free) var of an
        # active variant counts once per sweep per chain
        taken = sweeps * self.cpv * sum(
            int(mv.free_mask.sum()) for mv in self.variants
        )
        self.total_samples += taken
        if not defer:
            self.flush()
        return taken

    def flush(self) -> None:
        """Fold all pending window deltas into the host totals (one sync)."""
        for delta, nact in self._pending:
            d = np.asarray(delta, dtype=np.float64)
            d[nact:] = 0.0
            self.totals += d
        self._pending.clear()

    def restore_device_state(self, state: np.ndarray, halves: np.ndarray):
        """Place checkpointed chain state/window tensors on device
        (the sharded group overrides this to restore with its mesh
        shardings instead of single-device placement)."""
        self.state = jnp.asarray(state)
        self.halves = jnp.asarray(halves)

    # ---- estimation ------------------------------------------------------
    def rb_accumulate(self) -> None:
        """Snapshot the Rao-Blackwell mixture estimate for collapsed vars.

        The reference freezes a collapsed variable's marginal at collapse
        time as the local blanket enumeration (``gibbs-collapsed.go:243``)
        — static, and blind to the rest of the graph.  The true RB
        estimator averages the exact conditional P(var | blanket) over
        the collapsed variant's chain samples: the variant's chains
        sample the *marginalized* model, whose joint over the remaining
        vars is exactly the base joint with var integrated out, so the
        mixture converges to the true marginal (measured on Grids_13 the
        static approximation plateaus at mean Hellinger 0.418).

        One call accumulates one snapshot per (slot, collapsed var) into
        running sums; :meth:`merged_marginals` uses the running average
        when available and falls back to the static marginal otherwise.
        Engines call this at scoring cadence — chain states a window
        apart are decorrelated enough that snapshots stack like fresh
        samples.  Device work is one gather program for ALL collapsed
        vars (per-var host loops would pay a device round trip each).
        """
        if not self.rb_mixture:
            return
        v = self.caps.num_vars
        base_col = self.base.collapsed[:v]
        own = []
        col_any = np.zeros(v, dtype=bool)
        for slot, mv in enumerate(self.variants):
            extra = mv.collapsed[:v] & ~base_col
            col_any |= extra
            for var in np.nonzero(extra)[0]:
                own.append((slot, int(var)))
        if not own:
            return
        # plain-slot donors: every base-model slot snapshots every
        # collapsed var's conditional (see the _rbp_* field comment)
        plain_slots = [
            s for s, mv in enumerate(self.variants)
            if not (mv.collapsed[:v] & ~base_col).any()
        ]
        donors = [
            (p, int(cv)) for cv in np.nonzero(col_any)[0] for p in plain_slots
        ]
        probs = self._rb_snapshot(self.state, own + donors)
        for key, pr in zip(own, probs[: len(own)]):
            if key in self._rb_sum:
                self._rb_sum[key] = self._rb_sum[key] * RB_DECAY + pr
                self._rb_n[key] = self._rb_n[key] * RB_DECAY + 1.0
                self._rb_count[key] += 1
            else:
                self._rb_sum[key] = pr
                self._rb_n[key] = 1.0
                self._rb_count[key] = 1
        per_var: dict = {}
        for (_p, var), pr in zip(donors, probs[len(own):]):
            per_var.setdefault(var, []).append(pr)
        for var, prs in per_var.items():
            # same-tick donor snapshots combine at equal weight; the
            # decay applies once per tick, not between sibling slots
            self._rbp_accum(
                var, np.mean(prs, axis=0), self.cpv * len(prs)
            )

    def rb_accumulate_external(self, states, chains_per_slot: int,
                               n_slots: int = 1) -> None:
        """Accumulate plain-slot donor snapshots from ANOTHER group's
        base-model chain states (``states [N>=n_slots, C, V+1]`` on
        device).  The split group routes its full-width main slots here
        so the aux group's collapsed vars ride the fast ensemble."""
        if not self.rb_mixture or self.num_variants == 0:
            return
        v = self.caps.num_vars
        col_vars = np.nonzero(self.collapsed_any() & ~self.base.collapsed[:v])[0]
        pairs = [(s, int(cv)) for cv in col_vars for s in range(n_slots)]
        if not pairs:
            return
        per_var: dict = {}
        for (_s, var), pr in zip(pairs, self._rb_snapshot(states, pairs)):
            per_var.setdefault(var, []).append(pr)
        for var, prs in per_var.items():
            self._rbp_accum(
                var, np.mean(prs, axis=0), chains_per_slot * len(prs)
            )

    def _rbp_accum(self, var: int, probs: np.ndarray, weight: float):
        if var in self._rbp_sum:
            self._rbp_sum[var] = self._rbp_sum[var] * RB_DECAY + probs * weight
            self._rbp_w[var] = self._rbp_w[var] * RB_DECAY + weight
            self._rbp_snaps[var] += 1
        else:
            self._rbp_sum[var] = probs * weight
            self._rbp_w[var] = float(weight)
            self._rbp_snaps[var] = 1

    def _rb_snapshot(self, states, pairs) -> List[np.ndarray]:
        """One RB snapshot per (state-slot, var) pair: the normalized
        base conditional of ``var`` averaged over that slot's chains."""
        from grample_tpu.sampler.collapse import collapse_conditional

        v = self.caps.num_vars
        infos = []
        bmax = 1
        for _slot, var in pairs:
            info = self._rb_cond.get(var)
            if info is None:
                info = collapse_conditional(self.base, var)
                self._rb_cond[var] = info
            infos.append(info)
            bmax = max(bmax, info[0].size)
        # bucket-pad rows and blanket width to powers of two: the gather
        # program then compiles O(log) times per run instead of once per
        # adapt tick (n grows with every collapse; measured ~5 s compile
        # per tick on Grids_13, 22% of the whole run)
        n = _next_pow2(len(pairs))
        bmax = _next_pow2(bmax)
        slots = np.zeros(n, dtype=np.int32)
        slots[: len(pairs)] = [s for s, _ in pairs]
        # sentinel column (stride 0) pads ragged blankets and pad rows
        rest = np.full((n, bmax), v, dtype=np.int32)
        strides = np.zeros((n, bmax), dtype=np.int32)
        for i, (r, s, _c) in enumerate(infos):
            rest[i, : r.size] = r
            strides[i, : r.size] = s
        idx = np.asarray(
            _rb_indices(
                states,
                jnp.asarray(slots),
                jnp.asarray(rest),
                jnp.asarray(strides),
            )
        )
        out = []
        for (_r, _s, cond), row in zip(infos, idx):
            counts = np.bincount(row, minlength=cond.shape[0]).astype(np.float64)
            out.append(counts @ cond / counts.sum())
        return out

    def collapsed_any(self) -> np.ndarray:
        """[V] bool: collapsed in any active variant."""
        v = self.caps.num_vars
        out = np.zeros(v, dtype=bool)
        for mv in self.variants:
            out |= mv.collapsed[:v]
        return out

    def merged_marginals(self) -> np.ndarray:
        """Merged (unnormalized) marginal estimate [V, K] float64.

        Reference MergeChains semantics: per chain, marginal = uniform
        1/card seed + counts; summed across chains; any-collapsed wins
        with its exact marginal (first collapsing variant in slot order).
        """
        self.flush()
        v, k = self.caps.num_vars, self.kdim
        cards = self.base.cards
        valid = np.arange(k)[None, :] < cards[:, None]
        uniform = valid / np.maximum(cards[:, None], 1)
        merged = self.num_chains * uniform + self.totals[: self.num_variants, :v].sum(axis=0)
        # collapsed override in slot order, first-found wins (matches the
        # reference's break-on-found in MergeChains); the RB mixture
        # average supersedes the static collapse marginal once at least
        # RB_MIN_SNAPSHOTS decorrelated snapshots have accumulated (see
        # rb_accumulate) — scale is irrelevant, every consumer
        # renormalizes per row
        seen = np.zeros(v, dtype=bool)
        for slot, mv in enumerate(self.variants):
            for var in np.nonzero(mv.collapsed[:v] & ~seen)[0]:
                merged[var] = 0.0
                var_i = int(var)
                cnt = self._rb_count.get((slot, var_i), 0)
                psn = self._rbp_snaps.get(var_i, 0)
                have_own = self.rb_mixture and cnt >= RB_MIN_SNAPSHOTS
                have_plain = self.rb_mixture and psn >= RB_MIN_SNAPSHOTS
                if have_own or have_plain:
                    # chain-count-weighted blend of the variant's own
                    # (decayed) snapshot average and the plain-slot
                    # donor average — both converge to the true
                    # marginal; the weights let the statistically
                    # heavier source dominate
                    num, den = 0.0, 0.0
                    if have_own:
                        nrb = self._rb_n[(slot, var_i)]
                        w = nrb * self.cpv
                        num = self._rb_sum[(slot, var_i)] / nrb * w
                        den = w
                    if have_plain:
                        num = num + self._rbp_sum[var_i]
                        den = den + self._rbp_w[var_i]
                    est = num / den
                    merged[var, : est.size] = est
                else:
                    merged[var, : mv.marginals.shape[1]] = mv.marginals[var]
                seen[var] = True
        return merged

    def convergence(self, measure: str = "hellinger", merged: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-variable PSRF over all micro-chains. Returns [V] float."""
        v = self.caps.num_vars
        if merged is None:
            merged = self.merged_marginals()
        # slice to the active-slot pow2 bucket: with a full-capacity
        # reserve the PSRF would otherwise reduce over every reserved
        # slot's (masked) halves — 3-60x the live data early in an
        # adaptive run — while pow2 bucketing keeps recompiles O(log)
        nact = min(self.slot_cap, _next_pow2(max(1, self.num_variants)))
        h = self.halves[:nact, :, :, :v, :]  # [Nact, 2, C, V, K]
        m_chains = nact * self.cpv
        h1 = h[:, 0].reshape(m_chains, v, self.kdim)
        h2 = h[:, 1].reshape(m_chains, v, self.kdim)
        cmask = np.repeat(self._chain_mask()[:nact], self.cpv)
        converged = (self.base.fixed >= 0) | self.collapsed_any()
        vals = chain_convergence(
            h1,
            h2,
            jnp.asarray(merged, dtype=jnp.float32),
            jnp.asarray(self.base.cards, dtype=jnp.int32),
            jnp.asarray(converged),
            jnp.asarray(cmask),
            jnp.asarray(self.cw, dtype=jnp.float32),
            measure=measure,
        )
        return np.asarray(vals, dtype=np.float64)
