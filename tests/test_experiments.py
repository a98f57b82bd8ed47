"""Acceptance-harness semantics + the kelly19a adaptive>=plain claim.

The full-suite artifact is produced by ``grample_tpu.tools.experiments``
on the accelerator; here we validate the harness machinery and demonstrate the
paper's core claim (adaptive Rao-Blackwellisation beats plain Gibbs) on
``deterministic.uai`` — a near-reducible net where plain chains freeze
into their init mode while collapse yields the exact 0.5/0.5 marginal.
"""

import io
import json

import numpy as np
import pytest

from grample_tpu.tools.experiments import MODES, run_one, suite_nets, summarize

from tests.conftest import RES_DIR, res_path


def test_suite_nets_lists_mar_nets():
    res_path("one.uai")  # skip when data absent
    nets = suite_nets(RES_DIR)
    assert "one" in nets and "Grids_13" in nets
    assert "sample" not in nets  # no .MAR bundled


def test_run_one_produces_scores():
    res_path("one.uai")
    r = run_one(RES_DIR, "one", "plain", secs=5.0, vchains=32, seed=3)
    assert "error" not in r, r
    assert r["mean_hellinger"] < 0.05
    assert r["samples"] > 0


def test_adaptive_beats_plain_deterministic():
    """kelly19a: adaptive Rao-Blackwellisation >= plain Gibbs.

    On deterministic.uai the plain estimator's max Hellinger is a
    Binomial ensemble error (sigma = 0.5/sqrt(chains)) while adaptive
    collapse is exact, so adaptive wins by a wide, non-flaky margin.
    """
    res_path("deterministic.uai")
    # short windows so several adapt steps fit the CPU budget; the
    # exactness assertion below holds for the reference's STATIC
    # collapse-time marginal (rb_mixture averages P(var|blanket) over
    # chain samples, which carries 0.5/sqrt(chains) Monte-Carlo noise)
    kw = dict(secs=8.0, vchains=64, seed=7, burnin=60, cwin=120,
              rb_mixture=False)
    plain = run_one(RES_DIR, "deterministic", "plain", **kw)
    adaptive = run_one(RES_DIR, "deterministic", "adaptive", **kw)
    assert "error" not in plain and "error" not in adaptive
    assert adaptive["collapsed"] >= 1
    assert adaptive["max_hellinger"] <= plain["max_hellinger"]
    # collapse is exact here: adaptive must be essentially at zero error
    assert adaptive["max_hellinger"] < 0.01


def test_summarize_table_and_claim():
    rows = [
        {"net": "x", "mode": "adaptive", "mean_hellinger": 0.1,
         "max_hellinger": 0.2, "max_js": 0.1, "mean_js": 0.05,
         "samples_per_sec": 1e6, "merlin_mean_hellinger": 0.15},
        {"net": "x", "mode": "plain", "mean_hellinger": 0.2,
         "max_hellinger": 0.4, "max_js": 0.2, "mean_js": 0.1,
         "samples_per_sec": 1e6},
        {"net": "y", "mode": "plain", "error": "boom"},
    ]
    out = io.StringIO()
    wins, losses = summarize(rows, out)
    assert (wins, losses) == (1, 0)
    text = out.getvalue()
    assert "ERROR: boom" in text
    assert "adaptive <= plain" in text
