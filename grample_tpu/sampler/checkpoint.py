"""Checkpoint / resume for chain runs.

The reference has none (SURVEY.md §5 flags this as a genuine gap: runs
die with the process).  Long runs on shared or preemptible machines
can be cut, so the engine
periodically snapshots everything needed to continue a run bit-exactly:
chain states, split-half windows, count totals, the RNG step counter,
and the collapse-variant models themselves (serialized structurally,
not pickled, so checkpoints are portable and inspectable).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Tuple

import numpy as np

from grample_tpu.pgm.discrete import DiscreteModel, Factor
from grample_tpu.sampler.chains import ChainGroup

FORMAT_VERSION = 1


def _model_to_dict(m: DiscreteModel) -> dict:
    return {
        "type": m.type,
        "name": m.name,
        "cards": m.cards.tolist(),
        "fixed": m.fixed.tolist(),
        "collapsed": m.collapsed.tolist(),
        "marginals": m.marginals.tolist(),
        "factors": [
            {
                "name": f.name,
                "scope": f.scope.tolist(),
                "table": f.table.tolist(),
                "is_log": f.is_log,
            }
            for f in m.factors
        ],
    }


def _model_from_dict(d: dict) -> DiscreteModel:
    return DiscreteModel(
        type=d["type"],
        name=d["name"],
        cards=np.array(d["cards"], dtype=np.int64),
        fixed=np.array(d["fixed"], dtype=np.int64),
        collapsed=np.array(d["collapsed"], dtype=bool),
        marginals=np.array(d["marginals"], dtype=np.float64),
        factors=[
            Factor(f["name"], np.array(f["scope"]), np.array(f["table"]), f["is_log"])
            for f in d["factors"]
        ],
    )


def save_checkpoint(path: str, group, cfg=None, runtime: float = 0.0) -> None:
    """Atomic snapshot (tmp file + rename).

    A :class:`~grample_tpu.sampler.split.SplitChainGroup` saves its main
    group at ``path`` (with a ``split`` meta marker) and its aux group at
    ``path + ".aux"``.
    """
    from grample_tpu.sampler.split import SplitChainGroup

    if isinstance(group, SplitChainGroup):
        if group.aux is not None and group.aux.num_variants:
            _save_one(path + ".aux", group.aux, None, 0.0)
        split = {
            "aux": bool(group.aux is not None and group.aux.num_variants),
            "aux_cpv": group.aux_cpv,
            "cpv": group.cpv,
            "seed": group.seed,
            "rb_mixture": group.rb_mixture,
            "max_variants": group._max_variants,
        }
        _save_one(path, group.main, cfg, runtime, split=split)
        return
    _save_one(path, group, cfg, runtime)


def _save_one(path: str, group: ChainGroup, cfg=None, runtime: float = 0.0,
              split=None) -> None:
    group.flush()  # fold deferred window deltas into totals first
    meta = {
        "split": split,
        "version": FORMAT_VERSION,
        "cpv": group.cpv,
        "cw": group.cw,
        "seed": group.seed,
        "slot_cap": group.slot_cap,
        "step": group._step,
        "total_samples": group.total_samples,
        "total_sweeps": group.total_sweeps,
        "runtime": runtime,
        "variants": [_model_to_dict(m) for m in group.variants],
        "config": None if cfg is None else _cfg_dict(cfg),
    }
    arrays = {
        "state": np.asarray(group.state),
        "halves": np.asarray(group.halves),
        "totals": group.totals,
    }
    # RB mixture running sums (the conditional tables themselves are
    # deterministic functions of the base model and re-derived lazily)
    rb_keys = sorted(group._rb_sum)
    if rb_keys:
        arrays["rb_keys"] = np.array(rb_keys, dtype=np.int64)  # [n, 2]
        kmax = max(group._rb_sum[k].size for k in rb_keys)
        sums = np.zeros((len(rb_keys), kmax), dtype=np.float64)
        for i, k in enumerate(rb_keys):
            sums[i, : group._rb_sum[k].size] = group._rb_sum[k]
        arrays["rb_sums"] = sums
        arrays["rb_ns"] = np.array(
            [group._rb_n[k] for k in rb_keys], dtype=np.float64
        )
        arrays["rb_counts"] = np.array(
            [group._rb_count.get(k, 0) for k in rb_keys], dtype=np.int64
        )
    # plain-slot donor sums (chain-count weighted, keyed by var)
    rbp_keys = sorted(group._rbp_sum)
    if rbp_keys:
        arrays["rbp_vars"] = np.array(rbp_keys, dtype=np.int64)
        kmax = max(group._rbp_sum[k].size for k in rbp_keys)
        sums = np.zeros((len(rbp_keys), kmax), dtype=np.float64)
        for i, k in enumerate(rbp_keys):
            sums[i, : group._rbp_sum[k].size] = group._rbp_sum[k]
        arrays["rbp_sums"] = sums
        arrays["rbp_ws"] = np.array(
            [group._rbp_w[k] for k in rbp_keys], dtype=np.float64
        )
        arrays["rbp_snaps"] = np.array(
            [group._rbp_snaps[k] for k in rbp_keys], dtype=np.int64
        )
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", dir=os.path.dirname(os.path.abspath(path)) or "."
    )
    os.close(fd)
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_checkpoint(
    path: str, base_model: DiscreteModel, make_group=None
):
    """Rebuild a chain group from a snapshot. Returns (group, meta).

    ``make_group(model, **kw)`` constructs the group — pass a factory
    that builds a :class:`~grample_tpu.parallel.mesh.ShardedChainGroup`
    to resume a run onto a device mesh (the engine wires this from its
    ``--mesh`` config; r2 silently resumed single-device).  The factory
    must honor the snapshot's ``chains_per_variant``/``converge_window``/
    ``seed`` keywords — they define the tensor shapes being restored.

    Split snapshots (see :func:`save_checkpoint`) reconstruct a
    ``SplitChainGroup`` from ``path`` + ``path.aux``; the factory is
    ignored for them (split execution is single-device by design).
    """
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
    if meta.get("split"):
        from grample_tpu.sampler.split import SplitChainGroup, aux_group_factory

        sp = meta["split"]
        main, _ = _load_one(path, base_model, None)
        # the aux group must be rebuilt by the same factory a fresh
        # SplitChainGroup uses (dense-256 rowgather caps, 64-variant
        # limit) — a default ChainGroup would re-derive the heavyweight
        # collapse-headroom caps the split design exists to avoid
        # (ADVICE r3, medium)
        from grample_tpu.sampler.chains import MAX_VARIANTS

        mv = int(sp.get("max_variants", MAX_VARIANTS))
        aux = (
            _load_one(
                path + ".aux", base_model,
                aux_group_factory(mv, rb_mixture=sp.get("rb_mixture", True)),
            )[0]
            if sp["aux"] else None
        )
        group = SplitChainGroup(
            base_model,
            chains_per_variant=sp["cpv"],
            converge_window=main.cw,
            seed=sp["seed"],
            max_variants=mv,
            rb_mixture=sp.get("rb_mixture", True),
            aux_chains=sp["aux_cpv"],
            _main=main,
            _aux=aux,
        )
        return group, meta
    return _load_one(path, base_model, make_group)


def _load_one(
    path: str, base_model: DiscreteModel, make_group=None
) -> Tuple[ChainGroup, dict]:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    kw = dict(
        chains_per_variant=meta["cpv"],
        converge_window=meta["cw"],
        seed=meta.get("seed", 0),
        collapse_headroom=any(any(mv["collapsed"]) for mv in meta["variants"]),
    )
    group = (make_group or ChainGroup)(base_model, **kw)
    if not hasattr(group, "state"):
        # the factory produced a wrapper (e.g. SplitChainGroup) that
        # cannot restore a single-stack snapshot; rebuild as a plain
        # group with the snapshot's shapes — safe since collapse
        # variants encode dense under the collapse-headroom caps
        # (ADVICE r3, medium: resuming a non-split snapshot through an
        # adaptive split-eligible engine config crashed on attribute
        # access)
        group = ChainGroup(base_model, **kw)
    if group.cpv != meta["cpv"] or group.cw != meta["cw"]:
        raise ValueError("group factory ignored the checkpoint's shape keywords")
    for mv in meta["variants"]:
        group.add_variant(_model_from_dict(mv))
    group.reserve(meta.get("slot_cap", 0))
    # slot capacity may legitimately round UP on a mesh (the variant axis
    # tiles the device grid): keep the freshly initialized padding rows
    # and overwrite the snapshotted prefix
    state = np.array(group.state)  # copies: np.load views are read-only
    halves = np.array(group.halves)
    n = min(state.shape[0], data["state"].shape[0])
    state[:n] = data["state"][:n]
    halves[:n] = data["halves"][:n]
    group.restore_device_state(state, halves)
    group.totals[:n] = np.array(data["totals"], dtype=np.float64)[:n]
    group._step = meta["step"]
    group.total_samples = meta["total_samples"]
    group.total_sweeps = meta["total_sweeps"]
    if "rb_keys" in data:
        counts = (
            data["rb_counts"] if "rb_counts" in data
            else np.rint(np.asarray(data["rb_ns"]))  # pre-decay snapshots
        )
        for (slot, var), s, w, cnt in zip(
            data["rb_keys"], data["rb_sums"], data["rb_ns"], counts
        ):
            card = int(base_model.cards[int(var)])
            group._rb_sum[(int(slot), int(var))] = np.array(s[:card])
            group._rb_n[(int(slot), int(var))] = float(w)
            group._rb_count[(int(slot), int(var))] = int(cnt)
    if "rbp_vars" in data:
        for var, s, w, cnt in zip(
            data["rbp_vars"], data["rbp_sums"], data["rbp_ws"],
            data["rbp_snaps"]
        ):
            card = int(base_model.cards[int(var)])
            group._rbp_sum[int(var)] = np.array(s[:card])
            group._rbp_w[int(var)] = float(w)
            group._rbp_snaps[int(var)] = int(cnt)
    return group, meta


def _cfg_dict(cfg) -> dict:
    import dataclasses

    return dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
