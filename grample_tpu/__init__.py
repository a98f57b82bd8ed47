"""grample_tpu — batched-chain Gibbs inference for discrete PGM marginals.

A from-scratch JAX/XLA re-design of the capabilities of
CraigKelly/grample (adaptive Rao-Blackwellised Gibbs sampling for the UAI
"MAR" task, AISTATS 2019 "kelly19a").  Where the reference runs one
sequential random-scan chain per CPU goroutine, this framework runs
hundreds of thousands of vectorized chains per accelerator using
chromatic (graph-colored) parallel Gibbs over dense device-resident
factor tables, and shards chains over a `jax.sharding.Mesh`.

Layer map (bottom-up), mirroring the reference layer map (SURVEY.md §1):

  - ``grample_tpu.uai``      — UAI file format I/O (reference: model/uai.go)
  - ``grample_tpu.pgm``      — model core: variables/factors/validation,
                               dense tensor encoding, graph coloring
                               (reference: model/*.go)
  - ``grample_tpu.metrics``  — error suite + PSRF convergence
                               (reference: model/error.go, sampler/chain.go)
  - ``grample_tpu.ops``      — the compute path: the XLA Gibbs sweep
                               (reference: sampler/gibbs-simple.go hot loop)
  - ``grample_tpu.sampler``  — chain runtime, collapse engine, adaptive
                               controller (reference: sampler/*.go)
  - ``grample_tpu.parallel`` — mesh/sharding/collectives (reference:
                               goroutines + WaitGroup, §2 parallelism table)
  - ``grample_tpu.cli``      — CLI + orchestration (reference: cmd/*.go)
"""

__version__ = "0.1.0"

import os as _os


#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: one fixed path inside the checkout (git-ignored), so every process
#: of this checkout finds what an earlier one compiled.
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".cache", "jax",
)


def _enable_persistent_compile_cache() -> None:
    """Give JAX a persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; an application that configured a cache before
    importing this package also keeps its own.  Otherwise the cache goes
    to :data:`DEFAULT_COMPILE_CACHE`.
    """
    import jax

    if _os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.config.jax_compilation_cache_dir:
        return
    try:
        _os.makedirs(DEFAULT_COMPILE_CACHE, exist_ok=True)
    except OSError:  # read-only checkout: run without a persistent cache
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()

from grample_tpu.pgm.discrete import DiscreteModel, Factor  # noqa: F401
