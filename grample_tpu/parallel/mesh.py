"""Multi-chip chain sharding: mesh, shard_map sweep, collective merge.

The reference's only scaling mechanism is goroutines inside one OS
process (``sampler/chain.go:197-215`` joined at ``cmd/root.go:476-479``);
``MergeChains`` (``chain.go:96-148``) and ``ChainConvergence``
(``chain.go:32-92``) then reduce over chains on the main thread.  The
accelerator re-expression (SURVEY.md §2 parallelism table):

  - a 2-D device mesh ``("variants", "chains")``:
      * ``variants`` shards the collapse-variant slot axis N — each
        device group holds its own variants' factor-table encodings
        (the analogue of per-chain model clones, but sharded, not
        replicated per chain);
      * ``chains``  shards the micro-chain batch axis C — pure data
        parallelism over Gibbs chains;
  - the chromatic sweep runs under ``shard_map``: zero communication
    during sweeps (chains are independent by construction);
  - MergeChains becomes a ``psum`` of window count tensors over the
    ``chains`` axis (and an all-gather over ``variants`` at the host
    boundary);
  - ChainConvergence's over-chain sums become ``psum`` over BOTH axes,
    so PSRF is computed from global moments without materializing
    per-chain statistics anywhere.

This workload has no tensor/pipeline/sequence parallel axes (SURVEY.md
§2: models are ≲1 MB; the scale axis is chains), so dp-over-chains ×
dp-over-variants is the full, honest sharding story.  The collectives
are one count psum per window and the PSRF moment psums; every device
reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grample_tpu.ops.gibbs_xla import _advance_one
from grample_tpu.sampler.chains import ChainGroup

VARIANT_AXIS = "variants"
CHAIN_AXIS = "chains"


def chain_mesh(
    n_devices: Optional[int] = None, variant_ways: int = 0
) -> Mesh:
    """Build the ``(variants, chains)`` device mesh.

    ``variant_ways`` splits the device grid between the two axes; by
    default variants get the largest power-of-two ≤ √n so both axes
    scale.  With 1 device the mesh is (1, 1) and everything still works
    (shard_map over a unit mesh is the single-chip program).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if variant_ways <= 0:
        variant_ways = 1
        while variant_ways * variant_ways * 4 <= n:
            variant_ways *= 2
    if n % variant_ways != 0:
        raise ValueError(f"{n} devices not divisible by variant_ways={variant_ways}")
    grid = np.asarray(devs).reshape(variant_ways, n // variant_ways)
    return Mesh(grid, (VARIANT_AXIS, CHAIN_AXIS))


def _global_fold(key, n_local: int):
    """Per-local-variant keys that are globally unique across the mesh.

    Folds in (global variant index, chain-shard index) so no two shards
    ever reuse a Gumbel stream — the sharded analogue of the reference's
    single shared MT19937 stream (``rand/rand.go:24-37``).
    """
    vi0 = lax.axis_index(VARIANT_AXIS) * n_local
    ci = lax.axis_index(CHAIN_AXIS)
    key = jax.random.fold_in(key, ci)
    return jax.vmap(lambda i: jax.random.fold_in(key, vi0 + i))(
        jnp.arange(n_local, dtype=jnp.int32)
    )


# Sharding specs for the stacked encoding (leading axis N → "variants")
# and the chain state tensors.
ENC_SPEC = P(VARIANT_AXIS)
STATE_SPEC = P(VARIANT_AXIS, CHAIN_AXIS, None)  # [N, C, V+1]
HALVES_SPEC = P(VARIANT_AXIS, None, CHAIN_AXIS, None, None)  # [N, 2, C, V+1, K]


@partial(jax.jit, static_argnames=("mesh", "count"), donate_argnums=(1, 2))
def sharded_advance(
    mesh: Mesh,
    state,  # [N, C, V+1] int32, sharded (variants, chains)
    halves,  # [N, 2, C, V+1, K] f32, sharded
    stack,  # enc dict, leading axis N sharded over "variants"
    key,
    num_sweeps,  # traced int scalar — one compile for every window size
    half_point,
    count: bool = True,
):
    """One advance window over the mesh.

    Returns (state, halves, delta) where ``delta`` [N, V+1, K] is the
    window's count increment summed over ALL chains of each variant —
    the collective MergeChains input (psum over the chains axis, then
    implicitly all-gathered to hosts when fetched).  The sweep itself
    needs no collectives: each device advances its local shard.
    """

    def body(state, halves, stack, key, num_sweeps, half_point):
        keys = _global_fold(key, state.shape[0])
        fn = partial(_advance_one, count=count)
        state, halves = jax.vmap(fn, in_axes=(0, 0, 0, 0, None, None))(
            stack, state, halves, keys, num_sweeps, half_point
        )
        # int32 sum: counts are exact integers; f32 loses exactness past
        # 2^24 at large chain counts × window sizes
        delta = lax.psum(
            halves.astype(jnp.int32).sum(axis=(1, 2)), CHAIN_AXIS
        )  # [n_local, V+1, K]
        return state, halves, delta

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(STATE_SPEC, HALVES_SPEC, ENC_SPEC, P(), P(), P()),
        out_specs=(STATE_SPEC, HALVES_SPEC, P(VARIANT_AXIS)),
    )(state, halves, stack, key, jnp.asarray(num_sweeps), jnp.asarray(half_point))


@partial(jax.jit, static_argnames=("mesh", "measure"))
def sharded_convergence_moments(
    mesh: Mesh,
    halves,  # [N, 2, C, V+1, K] sharded
    merged,  # [V+1, K] replicated merged marginal estimate
    cards,  # [V+1] int32
    chain_mask,  # [N] bool (active variant slots), replicated
    measure: str = "hellinger",
):
    """Global PSRF moments via collectives: (sum_W, sum_B, m) each [V+1].

    The over-chain sums of ``ChainConvergence`` (``chain.go:51-74``)
    computed as a psum over both mesh axes; the caller finishes the
    scalar PSRF formula (cheap, shape [V]).
    """
    from grample_tpu.metrics.psrf import _SMOOTH, _measure

    def body(halves, merged, cards, chain_mask):
        n_local, _, c, v1, k = halves.shape
        vi0 = lax.axis_index(VARIANT_AXIS) * n_local
        active = lax.dynamic_slice_in_dim(chain_mask, vi0, n_local)  # [n_local]

        card_mask = jnp.arange(k)[None, :] < cards[:, None]  # [V+1, K]
        h1 = halves[:, 0] + _SMOOTH * card_mask  # [n_local, C, V+1, K]
        h2 = halves[:, 1] + _SMOOTH * card_mask
        within = _measure(measure, h1, h2, card_mask, cards)  # [n_local, C, V+1]
        between = _measure(measure, merged[None, None], h1 + h2, card_mask, cards)

        w = active[:, None, None].astype(within.dtype)  # [n_local, 1, 1]
        sum_w = (within * w).sum(axis=(0, 1))
        sum_b = (between * w).sum(axis=(0, 1))
        m = (active.astype(within.dtype) * c).sum()

        sum_w = lax.psum(lax.psum(sum_w, CHAIN_AXIS), VARIANT_AXIS)
        sum_b = lax.psum(lax.psum(sum_b, CHAIN_AXIS), VARIANT_AXIS)
        m = lax.psum(lax.psum(m, CHAIN_AXIS), VARIANT_AXIS)
        return sum_w, sum_b, m

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(HALVES_SPEC, P(), P(), P()),
        out_specs=(P(), P(), P()),
    )(halves, merged, cards, chain_mask)


def psrf_from_moments(sum_w, sum_b, m, cw, converged_mask):
    """Finish the PSRF formula from global moments (reference chain.go:76-89)."""
    m = jnp.maximum(m, 2.0)
    n = jnp.asarray(cw, sum_w.dtype)
    w = (1e-8 + sum_w) / m
    b = (1e-8 + sum_b) * (n / (m - 1.0))
    vhat = ((n - 1.0) / n) * w + ((m + 1.0) / (m * n)) * b
    psrf = jnp.sqrt((4.0 * vhat) / (2.0 * w))
    return jnp.where(converged_mask, 1.0, psrf)


class ShardedChainGroup(ChainGroup):
    """ChainGroup whose chain state lives sharded over a device mesh.

    Drop-in for :class:`ChainGroup`: the engine, adaptive controller and
    collapse machinery are unchanged — only where tensors live and how
    the advance/convergence reductions run differ.  Micro-chains per
    variant must divide the mesh's ``chains`` extent.
    """

    def __init__(self, *args, mesh: Optional[Mesh] = None, **kw):
        self.mesh = mesh or chain_mesh()
        super().__init__(*args, **kw)
        cdim = self.mesh.shape[CHAIN_AXIS]
        if self.cpv % cdim != 0:
            raise ValueError(
                f"chains_per_variant={self.cpv} not divisible by mesh "
                f"chains axis {cdim}"
            )

    # -- sharded placement -------------------------------------------------
    def _shard(self, x, spec):
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def _sharded_zeros(self, shape, spec):
        """Allocate zeros directly with the target sharding — never
        materialized on a single device first (ADVICE r1)."""
        return jax.jit(
            lambda: jnp.zeros(shape, jnp.float32),
            out_shardings=NamedSharding(self.mesh, spec),
        )()

    def _restack(self, new_slot_cap=None):
        # slot capacity must tile the mesh's variant extent
        if new_slot_cap is None and self.slot_cap == 0:
            return super()._restack(None)
        vdim = self.mesh.shape[VARIANT_AXIS]
        cap = self.slot_cap if new_slot_cap is None else new_slot_cap
        cap = ((max(cap, 1) + vdim - 1) // vdim) * vdim
        super()._restack(cap)
        if self.stack is None:
            return
        self.stack = {k: self._shard(v, ENC_SPEC) for k, v in self.stack.items()}
        self.state = self._shard(self.state, STATE_SPEC)

    def _alloc_halves(self):
        return self._sharded_zeros(
            (self.slot_cap, 2, self.cpv, self.v1, self.kdim), HALVES_SPEC
        )

    def add_variant(self, model, burn_sweeps=0, warm_marginals=None,
                    init_states=None):
        slot = super().add_variant(model, burn_sweeps, warm_marginals,
                                   init_states)
        self._repin()
        return slot

    def add_variants(self, models, burn_sweeps=0, warm_marginals=None,
                     init_states=None):
        slots = super().add_variants(models, burn_sweeps, warm_marginals,
                                     init_states)
        self._repin()
        return slots

    def _repin(self):
        # .at[].set on sharded arrays preserves sharding; re-pin anyway so
        # layout never silently degrades to single-device.
        self.stack = {k: self._shard(v, ENC_SPEC) for k, v in self.stack.items()}
        self.state = self._shard(self.state, STATE_SPEC)

    def restore_device_state(self, state, halves):
        """Checkpointed tensors come back sharded over the mesh."""
        self.state = self._shard(np.asarray(state, dtype=np.int32), STATE_SPEC)
        self.halves = self._shard(
            np.asarray(halves, dtype=np.float32), HALVES_SPEC
        )

    def _advance_window(self, sweeps, half, count: bool):
        """One sharded_advance call over the group's mesh."""
        return sharded_advance(
            self.mesh, self.state, self.halves, self.stack, self._next_key(),
            sweeps, half, count=count,
        )

    # -- sharded compute ----------------------------------------------------
    def warmup(self):
        if self.slot_cap == 0:
            return
        step = self._step
        state_h = np.asarray(self.state)
        halves_h = np.asarray(self.halves)
        self.state, self.halves, _ = self._advance_window(1, 0, count=True)
        self.state, self.halves, _ = self._advance_window(1, 1, count=False)
        np.asarray(self.halves)  # sync: wait out first-run overheads
        self.state = self._shard(state_h, STATE_SPEC)
        self.halves = self._shard(halves_h, HALVES_SPEC)
        self._step = step

    def burn(self, sweeps: int):
        if sweeps <= 0 or self.slot_cap == 0:
            return
        self.state, self.halves, _ = self._advance_window(
            int(sweeps), int(sweeps), count=False
        )
        self.total_sweeps += sweeps

    def advance(self, sweeps=None, defer: bool = False) -> int:
        sweeps = self.cw if sweeps is None else int(sweeps)
        # zeros_like preserves the HALVES_SPEC sharding — no single-device
        # transient (ADVICE r1)
        self.halves = jnp.zeros_like(self.halves)
        self.state, self.halves, delta = self._advance_window(
            sweeps, sweeps // 2, count=True
        )
        # same deferred-delta protocol as ChainGroup.advance: the psum'd
        # int32 delta stays on device until flush()
        self._pending.append((delta, self.num_variants))
        self.total_sweeps += sweeps
        taken = sweeps * self.cpv * sum(
            int(mv.free_mask.sum()) for mv in self.variants
        )
        self.total_samples += taken
        if not defer:
            self.flush()
        return taken

    def convergence(self, measure="hellinger", merged=None) -> np.ndarray:
        v = self.caps.num_vars
        if merged is None:
            merged = self.merged_marginals()
        mpad = np.zeros((self.v1, self.kdim), dtype=np.float32)
        mpad[:v, : merged.shape[1]] = merged
        sum_w, sum_b, m = sharded_convergence_moments(
            self.mesh,
            self.halves,
            jnp.asarray(mpad),
            jnp.asarray(np.append(self.base.cards, 1), dtype=jnp.int32),
            jnp.asarray(self._chain_mask()),
            measure=measure,
        )
        converged = (self.base.fixed >= 0) | self.collapsed_any()
        vals = psrf_from_moments(
            sum_w[:v], sum_b[:v], m, float(self.cw),
            jnp.asarray(converged),
        )
        return np.asarray(vals, dtype=np.float64)
