"""Collapse engine tests (reference gibbs-collapsed_test.go semantics)."""

import numpy as np
import pytest

from grample_tpu.pgm.discrete import DiscreteModel, Factor
from grample_tpu.pgm.exact import exact_marginals
from grample_tpu.sampler.collapse import (
    CollapseError,
    collapse_var,
    collapsible_vars,
    is_collapsible,
    pick_random_collapsible,
)
from grample_tpu.uai import load_model

from tests.conftest import res_path


def test_deterministic_collapse_exact_half():
    """Collapsing any var of deterministic.uai yields exactly 0.5/0.5
    (reference gibbs-collapsed_test.go:30-47)."""
    m = load_model(res_path("deterministic.uai"))
    for var in range(m.num_vars):
        _, exact = collapse_var(m, var)
        np.testing.assert_allclose(exact, [0.5, 0.5], atol=1e-9)


def test_collapse_matches_exact_when_incident_covers_model(rng):
    """When every factor is incident to the collapsed var, the collapse
    marginal equals the brute-force joint marginal."""
    factors = [
        Factor("f0", [0, 1], rng.random(4) + 0.1),
        Factor("f1", [1, 2], rng.random(6) + 0.1),
    ]
    m = DiscreteModel(type="MARKOV", cards=[2, 2, 3], factors=factors)
    truth = exact_marginals(m)
    _, exact = collapse_var(m, 1)  # var 1 touches both factors
    np.testing.assert_allclose(exact, truth[1, :2], rtol=1e-9, atol=1e-12)


def test_collapse_incident_only_semantics(rng):
    """The collapse marginal sums *incident* factors over the blanket —
    reference semantics (gibbs-collapsed.go:206-260): non-incident
    factors that couple blanket vars are deliberately excluded, so the
    result generally differs from the full joint marginal."""
    f0 = Factor("f0", [0, 1], rng.random(4) + 0.1)
    f1 = Factor("f1", [1, 2], rng.random(6) + 0.1)
    f2 = Factor("f2", [0, 2], rng.random(6) + 0.1)  # couples blanket, not var 1
    m = DiscreteModel(type="MARKOV", cards=[2, 2, 3], factors=[f0, f1, f2])
    _, exact = collapse_var(m, 1)
    # reference-semantics brute force: sum_{a,c} f0[a,b] f1[b,c]
    want = np.einsum("ab,bc->b", f0.table.reshape(2, 2), f1.table.reshape(2, 3))
    want = want / want.sum()
    np.testing.assert_allclose(exact, want, rtol=1e-9)
    # ...and it differs from the joint marginal here (f2 breaks equality)
    truth = exact_marginals(m)
    assert np.abs(exact - truth[1, :2]).max() > 1e-3


def test_collapse_respects_evidence(rng):
    factors = [
        Factor("f0", [0, 1], rng.random(4) + 0.1),
        Factor("f1", [1, 2], rng.random(4) + 0.1),
    ]
    m = DiscreteModel(type="MARKOV", cards=[2, 2, 2], factors=factors)
    m.apply_evidence({2: 1})
    truth = exact_marginals(m)
    _, exact = collapse_var(m, 1)
    np.testing.assert_allclose(exact, truth[1, :2], rtol=1e-9)


def test_collapse_graph_surgery():
    """Factors touching the var vanish; a COLLAPSE-* factor appears over
    blanket minus var (reference sample.uai bookkeeping test)."""
    m = load_model(res_path("sample.uai"))
    out, _ = collapse_var(m, 1)  # var B is in both pairwise factors
    assert out.collapsed[1]
    assert not any(1 in f.scope for f in out.factors[:-1])
    post = out.factors[-1]
    assert post.name == "COLLAPSE-B"
    assert sorted(int(u) for u in post.scope) == [0, 2]
    assert post.table.size == int(m.cards[0] * m.cards[2])
    out.check()
    # can't collapse the same variable twice
    with pytest.raises(CollapseError):
        collapse_var(out, 1)
    # input model untouched
    assert not m.collapsed.any()
    assert len(m.factors) == 3


def test_collapse_replacement_table_values(rng):
    """Replacement factor table = sum over var of prod(incident factors)."""
    f0 = Factor("f0", [0, 1], rng.random(4) + 0.1)
    f1 = Factor("f1", [1, 2], rng.random(4) + 0.1)
    m = DiscreteModel(type="MARKOV", cards=[2, 2, 2], factors=[f0, f1])
    out, _ = collapse_var(m, 1)
    post = out.factors[-1]
    # post over scope [0, 2]: post[a,c] = sum_b f0[a,b] * f1[b,c]
    want = np.einsum("ab,bc->ac", f0.table.reshape(2, 2), f1.table.reshape(2, 2))
    np.testing.assert_allclose(post.table.reshape(2, 2), want, rtol=1e-9)


def test_collapse_guards():
    m = load_model(res_path("sample.uai"))
    m.apply_evidence({0: 1})
    with pytest.raises(CollapseError):
        collapse_var(m, 0)  # fixed
    # single-var model: blanket == {var}, no replacement factor possible
    one = load_model(res_path("one.uai"))
    with pytest.raises(CollapseError):
        collapse_var(one, 0)
    assert not is_collapsible(one, 0)


def test_collapsible_vars_blanket_limit():
    """Alchemy_11 has blankets up to 60: those vars must be excluded
    (NeighborVarMax=12), matching the reference's per-variable gating."""
    m = load_model(res_path("Alchemy_11.uai"), use_evidence=True)
    cv = collapsible_vars(m)
    blankets = m.blankets()
    assert all(len(blankets[v]) <= 12 for v in cv)
    assert len(cv) < m.num_vars


def test_pick_random_collapsible(rng):
    m = load_model(res_path("sample.uai"))
    got = {pick_random_collapsible(m, np.random.default_rng(s)) for s in range(20)}
    got.discard(None)
    assert got  # finds something
    assert all(is_collapsible(m, v) for v in got)


def test_object_detection_table_cap():
    """ObjectDetection card-16 blankets pass the var-count check but bust
    the 2^23 table cap — is_collapsible must reject them up front."""
    m = load_model(res_path("ObjectDetection_11.uai"), use_evidence=True)
    for v in collapsible_vars(m):
        out, _ = collapse_var(m, v)  # must not raise
        out.check()
        break


# ---- dense-256 collapse guard (the gather bank under stacked variants
# is the slow path; collapse variants must stay on the dense one-hot
# path) ---------------------------------------------------------------------

def _star(n_leaves: int, rng) -> DiscreteModel:
    """Binary star: center 0 coupled pairwise to each leaf (Promedus-like
    topology — the blanket of 0 is all leaves)."""
    factors = [
        Factor(f"f{i}", [0, i], rng.random(4) + 0.1)
        for i in range(1, n_leaves + 1)
    ]
    return DiscreteModel(
        type="MARKOV", cards=[2] * (n_leaves + 1), factors=factors
    )


def test_is_collapsible_oa_cap_guard(rng):
    m = _star(9, rng)  # rest 9 -> replacement table 512, OA 256
    assert is_collapsible(m, 0)
    assert is_collapsible(m, 0, oa_cap=256)
    assert not is_collapsible(m, 0, oa_cap=32)

    big = _star(10, rng)  # rest 10 -> table 1024, OA 512
    assert is_collapsible(big, 0)  # reference guard alone allows it
    assert not is_collapsible(big, 0, oa_cap=256)


def test_collapse_headroom_caps_stay_dense(rng):
    """Collapse-headroom caps classify replacement factors dense (no
    gather-bank growth) and a blanket-10 variant encodes with an empty
    gather bank."""
    from grample_tpu.pgm.encode import (
        COLLAPSE_OA_DENSE_CAP,
        compute_caps,
        encode_model,
        merge_caps,
    )

    m = _star(9, rng)
    caps = compute_caps(m, collapse_headroom=True, slot_hint=8)
    assert caps.oa_dense_cap == COLLAPSE_OA_DENSE_CAP
    assert caps.gfac_cap == 0
    assert caps.oa_cap == 256

    variant, _ = collapse_var(m, 0)
    caps = merge_caps(caps, compute_caps(variant, oa_dense_cap=caps.oa_dense_cap))
    enc = encode_model(variant, caps)
    assert enc.gb_mask.sum() == 0, "collapse variant must hold no gather rows"
    assert (np.abs(enc.sw_local_tables).max(axis=(3, 4)) > 0).any()


def test_adapt_guard_skips_gather_candidates(rng):
    """adapt_step must never build a variant the group's dense cap
    excludes (it would re-create the crashing gather tier)."""
    from grample_tpu.sampler.adaptive import adapt_step
    from grample_tpu.sampler.chains import ChainGroup

    m = _star(10, rng)  # center OA 512 > 256: not dense-eligible
    g = ChainGroup(m, chains_per_variant=8, converge_window=8, seed=1,
                   collapse_headroom=True)
    g.add_variant(m)
    g.add_variant(m)
    g.advance(8)
    added = adapt_step(g, 4)
    # the center (blanket 11) is excluded; leaves (blanket 2, the
    # center) are eligible
    assert 0 not in added
    for v in added:
        assert is_collapsible(m, v, oa_cap=g.collapse_oa_cap)


def test_split_capacity_reporting(rng):
    """SplitChainGroup.max_variants reflects main slots + aux capacity
    (ADVICE r3: reporting the configured limit let adapt_step overfill
    the aux group and abort the run)."""
    from grample_tpu.sampler.split import AUX_MAX_VARIANTS, SplitChainGroup

    m = _star(3, rng)
    g = SplitChainGroup(m, chains_per_variant=8, converge_window=8, seed=1,
                        aux_chains=8, max_variants=128)
    g.add_variant(m)
    g.add_variant(m)
    assert g.max_variants == 2 + AUX_MAX_VARIANTS
    variant, _ = collapse_var(m, 0)
    g.add_variant(variant)
    assert g.max_variants == 2 + AUX_MAX_VARIANTS  # aux slot, not main


def test_split_aux_caps_factory_parity(rng, tmp_path):
    """Checkpoint resume rebuilds the aux group with the same dense-256
    rowgather caps a fresh SplitChainGroup uses (ADVICE r3: resume
    restored the heavyweight default collapse-headroom caps)."""
    from grample_tpu.sampler.checkpoint import load_checkpoint, save_checkpoint
    from grample_tpu.sampler.split import SplitChainGroup

    m = _star(4, rng)
    g = SplitChainGroup(m, chains_per_variant=8, converge_window=8, seed=1,
                        aux_chains=8)
    g.add_variant(m)
    g.add_variant(m)
    variant, _ = collapse_var(m, 1)
    g.add_variant(variant, burn_sweeps=2)
    g.advance(8)
    path = str(tmp_path / "split.npz")
    save_checkpoint(path, g)

    g2, _meta = load_checkpoint(path, m)
    assert isinstance(g2, SplitChainGroup)
    assert g2.aux is not None
    assert g2.aux.caps.base_mode == g.aux.caps.base_mode == "rowgather"
    assert g2.aux.caps.oa_dense_cap == g.aux.caps.oa_dense_cap
    assert g2.aux.max_variants == g.aux.max_variants


def test_nonsplit_snapshot_under_split_factory(rng, tmp_path):
    """A plain-group snapshot must resume even when the engine factory
    would produce a SplitChainGroup (ADVICE r3: AttributeError crash)."""
    from grample_tpu.sampler.chains import ChainGroup
    from grample_tpu.sampler.checkpoint import load_checkpoint, save_checkpoint
    from grample_tpu.sampler.split import SplitChainGroup

    m = _star(4, rng)
    g = ChainGroup(m, chains_per_variant=8, converge_window=8, seed=1,
                   collapse_headroom=True)
    g.add_variant(m)
    variant, _ = collapse_var(m, 1)
    g.add_variant(variant)
    g.advance(8)
    path = str(tmp_path / "plain.npz")
    save_checkpoint(path, g)

    def split_factory(model, **kw):
        return SplitChainGroup(model, **kw)

    g2, _meta = load_checkpoint(path, m, make_group=split_factory)
    assert isinstance(g2, ChainGroup)
    assert g2.num_variants == 2
    before = g2.total_samples
    g2.advance(4)
    assert g2.total_samples > before
