"""The on-chip smoke test's own pieces, checked where they can be.

The generator, the transfer-matrix exact marginals, the float64 logits
reference and its comparison with the sweep, the device guard, the trace
reduction and the compile-cache placement all run on the CPU here; the
``gpu``-marked cases run the comparison on a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from grample_tpu.pgm.exact import exact_marginals

from tests.test_gibbs import brute_logits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_grid_net_shape():
    """Grids_13 shape: 100 binary vars, 100 unary + 180 pairwise factors,
    pairwise log-potentials within +-coupling, 10 evidence vars."""
    m, ev = cs.grid_net(seed=3)
    assert m.num_vars == 100 and np.all(m.cards == 2)
    sizes = [f.scope.size for f in m.factors]
    assert sizes.count(1) == 100 and sizes.count(2) == 180
    pair = np.concatenate([np.log(f.table) for f in m.factors if f.scope.size == 2])
    assert np.abs(pair).max() <= 10.0 and np.abs(pair).max() > 9.0
    assert len(ev) == 10 and all(0 <= u < 100 and val in (0, 1) for u, val in ev.items())
    m.check()


@pytest.mark.parametrize("side,coupling,n_ev", [(3, 1.0, 2), (4, 3.0, 3), (4, 10.0, 5)])
def test_grid_exact_matches_bruteforce(side, coupling, n_ev):
    m, ev = cs.grid_net(side=side, coupling=coupling, n_evidence=n_ev, seed=side)
    m = cs.with_evidence(m, ev)
    np.testing.assert_allclose(cs.grid_exact(m, side), exact_marginals(m), atol=1e-10)


@pytest.mark.parametrize("mode", cs.SWEEP_MODES)
def test_sweep_logits_vs_reference(mode):
    """The phase-2 comparison at small width: the float64 reference
    equals direct factor evaluation, and the sweep's logits in each mode
    agree with it within the on-card tolerance."""
    m, ev = cs.grid_net(side=4, coupling=10.0, n_evidence=3, seed=7)
    m = cs.with_evidence(m, ev)
    state = cs.random_state(m, 16, seed=2)
    ref = cs.reference_logits(m, state)
    for c in (0, 15):
        for u in np.nonzero(m.fixed < 0)[0]:
            np.testing.assert_allclose(ref[u, :, c], brute_logits(m, state[c], u), atol=1e-12)
    assert cs.logits_max_error(m, mode, state, ref) <= cs.LOGITS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", cs.SWEEP_MODES)
def test_sweep_logits_on_gpu(mode, gpu_device):
    import jax

    m, ev = cs.grid_net(seed=1)
    m = cs.with_evidence(m, ev)
    state = cs.random_state(m, 4096, seed=1)
    with jax.default_device(gpu_device):
        assert cs.logits_max_error(m, mode, state) <= cs.LOGITS_TOL


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.require_gpu()


def test_busy_ns_unions_intervals():
    assert cs.busy_ns([]) == 0
    assert cs.busy_ns([(10, 20), (0, 5), (15, 30), (40, 41)]) == 5 + 20 + 1


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache goes
    to one fixed directory inside the checkout."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, grample_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout.strip().splitlines()[-1]
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".cache", "jax")
    assert out == want
