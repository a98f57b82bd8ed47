"""SplitChainGroup: fast plain slots + slow collapse slots.

The split runs full-width plain caps beside reduced-chain rowgather
collapse caps (see sampler/split.py); every semantic contract — variant routing,
MergeChains any-collapsed-wins, PSRF masking, checkpoint round-trip —
is backend-independent and validated here with ``split_group="on"``.
"""

import os

import numpy as np
import pytest

from grample_tpu.sampler.chains import ChainGroup
from grample_tpu.sampler.collapse import collapse_var
from grample_tpu.sampler.engine import Engine, EngineConfig
from grample_tpu.sampler.split import SplitChainGroup
from grample_tpu.uai import load_model

from tests.conftest import res_path


@pytest.fixture
def det_model():
    p = res_path("deterministic.uai")
    return load_model(p, use_evidence=os.path.exists(p + ".evid"))


def test_variant_routing_and_merge(det_model):
    g = SplitChainGroup(det_model, chains_per_variant=64, converge_window=16,
                        seed=3, aux_chains=32)
    g.add_variant(det_model)
    g.add_variant(det_model)
    assert g.aux is None and g.main.num_variants == 2

    variant, _ = collapse_var(det_model, 0)
    g.add_variant(variant, burn_sweeps=2)
    assert g.aux is not None and g.aux.num_variants == 1
    assert g.num_variants == 3
    assert g.num_chains == 2 * 64 + 32
    assert list(g.collapsed_any()) == [True, False, False]

    g.burn(4)
    g.advance(16)
    merged = g.merged_marginals()
    # any-collapsed wins: var 0's row is the aux variant's exact/RB
    # marginal, not a count sum over 160 chains
    aux_m = g.aux.merged_marginals()
    np.testing.assert_allclose(merged[0], aux_m[0])
    assert g.total_samples > 0

    # PSRF: collapsed var pinned at 1.0 (reference chain.go:86-89)
    conv = g.convergence()
    assert conv[0] == 1.0


def test_split_engine_run_and_resume(det_model, tmp_path):
    ck = str(tmp_path / "split.npz")
    cfg = EngineConfig(
        model_path=res_path("deterministic.uai"),
        use_evidence=True, use_solution=True, sampler="adaptive",
        chains=2, chains_per_variant=64, chain_adds=2, max_secs=6.0,
        seed=7, burnin=1500, converge_window=3000, split_group="on",
        status_secs=1e9, checkpoint_path=ck, checkpoint_secs=2.0,
    )
    res = Engine(cfg, log=lambda s: None).run()
    assert res.collapsed, "adaptation must have collapsed at least one var"
    assert res.final_score.max_hellinger < 0.15
    assert os.path.exists(ck)

    # resume reconstructs the split pair and continues
    from grample_tpu.sampler.checkpoint import load_checkpoint

    group, meta = load_checkpoint(ck, det_model)
    assert isinstance(group, SplitChainGroup)
    assert meta["split"]["cpv"] == 64
    if meta["split"]["aux"]:
        assert group.aux is not None and group.aux.num_variants >= 1
        assert isinstance(group.aux, ChainGroup)
    before = group.total_samples
    group.advance(4)
    assert group.total_samples > before

    # the resumed run restarts from the last checkpoint, which predates
    # the first run's final counts — so only structural continuation is
    # asserted, not a sample-count ordering
    cfg2 = EngineConfig(**{**cfg.__dict__, "resume": True, "max_secs": 2.0})
    res2 = Engine(cfg2, log=lambda s: None).run()
    assert res2.samples > 0
    assert np.isfinite(res2.final_score.max_hellinger)
