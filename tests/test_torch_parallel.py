"""The port's sharded PT sampler over torch.distributed ranks, on the CPU
over gloo, against the one-process port run and the JAX package.

The contract is the JAX package's (tests/test_sharded_run.py,
tests/test_multiprocess.py): a sharded run computes exactly what the
unsharded run computes, and its per-rank shards merge to the same store.
Here "exactly" is bit for bit in float64 on the banana fixture, over 2
and 4 ranks, with whole ladders and with ladders that a rank boundary
splits (under deterministic_even_odd and stochastic_random), across a GMM
boundary and a clustered_autoblock boundary, and through checkpoints in
both directions. The partition is held to the JAX package's chain
sharding block for block, and one exchange step across a split ladder to
the JAX package's `_exchange` with its own uniforms (1e-12).

Each world size is spawned once (a module fixture) and runs all of its
cases; the one-process references run in this process. This module
imports no JAX at top level: the ranks import it to find their cases.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from bcm3_tpu_torch import Prior, VariableSet, convert, create_likelihood, entry
from bcm3_tpu_torch.io import hdf5r_compat
from bcm3_tpu_torch.io.checkpoint import STATE_CHAIN_FIELDS
from bcm3_tpu_torch.io.output import merge_sharded_results
from bcm3_tpu_torch.merge_shards import main as merge_main
from bcm3_tpu_torch.parallel import ChainBlock, chain_partition, collectives, launch
from bcm3_tpu_torch.parallel import shard_leading_axis
from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

KEYS = ("samples", "log_prior", "log_likelihood")
SCHEMES = ("deterministic_even_odd", "stochastic_random")
BASE = dict(num_samples=40, use_every_nth=2, adapt_proposal_samples=20, adapt_proposal_times=1,
            seed=9)
# the JAX multiprocess test's configuration (tests/test_multiprocess.py:94-105):
# whole ladders, two ensembles a rank
WHOLE = dict(BASE, num_chains=4, num_ensembles=4)
# a rank boundary splits a ladder: 4 x 1 over 2 ranks, 6 x 2 over 4 ranks
SPLIT = {2: dict(BASE, num_chains=4, num_ensembles=1), 4: dict(BASE, num_chains=6, num_ensembles=2)}
CLUSTERED = dict(BASE, num_chains=4, num_ensembles=3, proposal_type="clustered_covariance",
                 blocking_strategy="clustered_autoblock")
# 12 chains over 2 ranks (the second ladder split); run A stops at the boundary
CHECKPOINTED = dict(BASE, num_chains=4, num_ensembles=3)
EXCHANGE = dict(num_chains=4, num_ensembles=1, num_samples=4, adapt_proposal_samples=0,
                adapt_proposal_times=0, seed=3)
EXCHANGE_KEYS = (100, 101, 102, 103)  # two steps at each parity


def _sampler(**cfg):
    prior_xml = os.path.join(entry.BANANA, "prior.xml")
    vs = VariableSet.from_xml(prior_xml)
    return SamplerPT(
        Prior.from_xml(prior_xml, vs),
        create_likelihood(os.path.join(entry.BANANA, "likelihood.xml"), vs),
        PTConfig(device="cpu", dtype=torch.float64, **cfg),
    )


def _run(**cfg):
    res = _sampler(**cfg).run()
    return {k: res[k] for k in KEYS + ("acceptance", "ensemble_shard", "evaluations",
                                       "num_ensembles", "adaptation_boundaries")}


# ---------------------------------------------------------------------------
# The ranks' cases


def _exchange_steps(inputs):
    """Exchange steps from the JAX package's state with its uniforms; the
    whole population's state after each, and each step's point-to-point
    calls."""
    s = _sampler(shard_over_devices=True, **EXCHANGE)
    full = convert.pt_state_from_arrays(inputs["state"], "cpu", torch.float64)
    state = dataclasses.replace(full, **{f: s._cover(getattr(full, f)) for f in STATE_CHAIN_FIELDS})
    steps = []
    for u in inputs["uniforms"]:
        collectives.reset_counts()
        state = s._exchange(state, s._cover(torch.as_tensor(u)))
        steps.append(dict(
            {f: s._gather(getattr(state, f)).numpy() for f in STATE_CHAIN_FIELDS},
            swap_parity=state.swap_parity, p2p=collectives.exchange_boundary_rows.calls,
        ))
    return steps


def _segment_calls(cfg):
    """The collective calls of a 3-sample segment."""
    s = _sampler(shard_over_devices=True, **dict(cfg, adapt_proposal_samples=0,
                                                 adapt_proposal_times=0))
    state = s._init_state()
    collectives.reset_counts()
    s._run_segment(state, list(s.proposals), 3)
    return {fn.__name__: fn.calls for fn in (
        collectives.all_gather_rows, collectives.all_reduce_sum,
        collectives.exchange_boundary_rows, collectives.broadcast_object, collectives.barrier)}


class _Kept:
    """A sample handler that keeps what it receives and where it was told
    to resume."""

    def __init__(self):
        self.parts, self.position = [], None

    def receive_samples(self, xs, lprior, llh, temperatures, weights=None):
        self.parts.append((xs, lprior, llh))

    def set_position(self, ix):
        self.position = ix


def _run_with_handler(**cfg):
    """A sharded run with a _Kept handler attached on this rank: the rows
    its handler received (None if none), the position it was given, and
    the run's own rows."""
    s = _sampler(shard_over_devices=True, **cfg)
    h = _Kept()
    s.sample_handlers = [h]
    res = s.run()
    got = None
    if h.parts:
        got = {k: np.concatenate(p) for k, p in zip(KEYS, zip(*h.parts))}
    return {"handled": got, "position": h.position, "ensemble_shard": res["ensemble_shard"],
            **{k: res[k] for k in KEYS}}


def _refusal(**cfg):
    try:
        _sampler(shard_over_devices=True, **cfg)
    except ValueError as e:
        return str(e)
    return None


def _world2_cases(rank, world, inputs):
    d = inputs["dir"]
    out = {
        "exchange": _exchange_steps(inputs["exchange"]),
        "segment_calls": {"whole": _segment_calls(WHOLE), "split": _segment_calls(SPLIT[2])},
        "runs": {f"split_{s}": _run(shard_over_devices=True, **dict(SPLIT[2], swapping_scheme=s))
                 for s in SCHEMES},
        "indivisible": _refusal(**dict(BASE, num_chains=3, num_ensembles=1)),
        "mesh_devices": _refusal(**dict(WHOLE, mesh_devices=1)),
    }
    out["runs"]["whole"] = whole = _run(shard_over_devices=True, **WHOLE)
    out["runs"]["clustered"] = _run(shard_over_devices=True, **CLUSTERED)
    # per-rank emission with a handler on every rank; then resumed from a
    # checkpoint at the boundary
    out["handled"] = _run_with_handler(**WHOLE)
    ck = os.path.join(d, "whole.ckpt")
    _run(shard_over_devices=True, **dict(WHOLE, num_samples=20, checkpoint_file=ck))
    out["handled_resumed"] = _run_with_handler(**dict(WHOLE, checkpoint_file=ck))
    # the layout of parallel/run_distributed.py's shards, for merge_shards
    vs = VariableSet.from_xml(os.path.join(entry.BANANA, "prior.xml"))
    np.savez(
        os.path.join(d, f"samples_shard{rank}.npz"),
        **{k: whole[k] for k in KEYS},
        e0=whole["ensemble_shard"][0], e_local=whole["ensemble_shard"][1],
        num_ensembles=whole["num_ensembles"],
        temperatures=_sampler(**WHOLE).emit_ladder,
        variables=np.array(vs.names),
        variable_transform=np.asarray(vs.transforms, dtype=np.uint32),
    )
    # checkpoints: sharded A then sharded B; sharded from an unsharded A
    ck = os.path.join(d, "sharded.ckpt")
    out["ckpt_a"] = _run(shard_over_devices=True, **dict(CHECKPOINTED, num_samples=20,
                                                         checkpoint_file=ck))
    if rank == 0:
        shutil.copy(ck, os.path.join(d, "sharded_a.ckpt"))
    collectives.barrier()
    out["ckpt_b"] = _run(shard_over_devices=True, **dict(CHECKPOINTED, checkpoint_file=ck))
    out["ckpt_from_unsharded"] = _run(shard_over_devices=True, **dict(
        CHECKPOINTED, checkpoint_file=os.path.join(d, "unsharded_a.ckpt")))
    return out


def _world4_cases(rank, world):
    return {
        "runs": {s: _run(shard_over_devices=True, **dict(SPLIT[4], swapping_scheme=s))
                 for s in SCHEMES},
        "segment_calls": _segment_calls(SPLIT[4]),
    }


# ---------------------------------------------------------------------------
# Fixtures


@pytest.fixture(scope="module")
def jax_exchange():
    """The JAX package's state of EXCHANGE and its exchange steps, each
    with the uniforms that its `_exchange` draws from the key
    (bcm3_tpu/sampler/pt.py:809)."""
    import jax

    from bcm3_tpu.likelihoods import create_likelihood as jcreate
    from bcm3_tpu.model.prior import Prior as JPrior
    from bcm3_tpu.model.variables import VariableSet as JVariableSet
    from bcm3_tpu.sampler import PTConfig as JPTConfig
    from bcm3_tpu.sampler import SamplerPT as JSamplerPT

    prior_xml = os.path.join(entry.BANANA, "prior.xml")
    jvs = JVariableSet.from_xml(prior_xml)
    js = JSamplerPT(JPrior.from_xml(prior_xml, jvs),
                    jcreate(os.path.join(entry.BANANA, "likelihood.xml"), jvs),
                    JPTConfig(**EXCHANGE))
    jstate = js._init_state()
    start = {f: np.asarray(getattr(jstate, f)) for f in convert.STATE_FIELDS}
    uniforms, after = [], []
    for seed in EXCHANGE_KEYS:
        key = jax.random.PRNGKey(seed)
        uniforms.append(np.asarray(jax.random.uniform(key, (js.num_chains,), dtype=np.float64)))
        jstate = js._exchange(jstate, key)
        after.append({f: np.asarray(getattr(jstate, f)) for f in convert.STATE_FIELDS})
    return {"state": start, "uniforms": uniforms}, after


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_exchange):
    d = str(tmp_path_factory.mktemp("world2"))
    # the unsharded run A whose checkpoint a sharded run resumes
    _run(**dict(CHECKPOINTED, num_samples=20, checkpoint_file=os.path.join(d, "unsharded_a.ckpt")))
    ranks = launch.spawn(_world2_cases, 2, "cpu", {"dir": d, "exchange": jax_exchange[0]})
    return d, ranks


@pytest.fixture(scope="module")
def world4():
    return launch.spawn(_world4_cases, 4, "cpu")


@pytest.fixture(scope="module")
def whole_ref():
    """The one-process run of WHOLE."""
    return _run(**WHOLE)


def _assert_same_run(res, ref):
    for k in KEYS:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    for k, v in ref["acceptance"].items():
        np.testing.assert_array_equal(res["acceptance"][k], v, err_msg=k)
    assert res["evaluations"] == ref["evaluations"]


# ---------------------------------------------------------------------------
# The partition


@pytest.mark.parametrize("C", [8, 16, 24])
def test_partition_matches_the_jax_chain_sharding(C):
    """Rank r's block is the rows that NamedSharding(mesh, P("chain"))
    gives device r of the JAX package's 8-device mesh, and
    shard_leading_axis keeps the same rows and leaves other leaves whole."""
    import jax

    from bcm3_tpu.parallel.mesh import chain_mesh, chain_sharding
    from bcm3_tpu.parallel.mesh import shard_leading_axis as jax_shard_leading_axis

    mesh = chain_mesh(8)
    order = list(mesh.devices.flat)
    arr = jax.device_put(np.arange(C), chain_sharding(mesh))
    blocks = chain_partition(C, 8)
    for shard in arr.addressable_shards:
        index = shard.index[0]
        assert blocks[order.index(shard.device)] == (index.start, index.stop)
    tree = {"x": np.arange(C * 3.0).reshape(C, 3), "w": np.arange(5.0)}
    jtree = jax_shard_leading_axis(tree, mesh, C)
    for r, device in enumerate(order):
        mine = shard_leading_axis(tree, r, 8, C)
        (xs,) = [s.data for s in jtree["x"].addressable_shards if s.device == device]
        np.testing.assert_array_equal(mine["x"], np.asarray(xs))
        np.testing.assert_array_equal(mine["w"], tree["w"])


@pytest.mark.parametrize("C,L,W", [(4, 4, 2), (12, 6, 4), (12, 4, 3), (16, 4, 4), (8, 8, 8)])
def test_halo_plans_pair_up(C, L, W):
    """What a rank sends a peer is what the peer receives from it, and a
    rank receives exactly the ladder neighbours of its rows that it does
    not own; whole ladders need no plan."""
    blocks = [ChainBlock(C, L, r, W) for r in range(W)]
    plans = [{peer: (send, recv) for peer, send, recv in b.halo_plan()} for b in blocks]
    for r, b in enumerate(blocks):
        assert (b.c0, b.c1) == chain_partition(C, W)[r]
        assert b.a0 % L == 0 and b.a1 % L == 0 and b.a0 <= b.c0 < b.c1 <= b.a1
        if b.whole:
            assert plans[r] == {}
        needed = set()
        for peer, (send, recv) in plans[r].items():
            assert [i + b.a0 for i in recv] == [i + blocks[peer].a0 for i in plans[peer][r][0]]
            needed.update(i + b.a0 for i in recv)
        neighbours = {c - c % L + (c % L + s) % L for c in range(b.c0, b.c1) for s in (1, -1)}
        assert needed == neighbours - set(range(b.c0, b.c1))


# ---------------------------------------------------------------------------
# Two ranks


def test_exchange_across_a_split_ladder_matches_jax(world2, jax_exchange):
    """Four exchange steps of a 4-chain ladder split over 2 ranks (the
    pairs (1, 2) and (3, 0) cross the boundary at parity 1) equal the JAX
    package's `_exchange` with the same uniforms; each step exchanges the
    boundary rows point to point once."""
    _, ranks = world2
    _, after = jax_exchange
    crossed = 0
    for r in ranks:
        for it, (mine, ref) in enumerate(zip(r["exchange"], after)):
            for f in ("x", "lprior", "llh"):
                np.testing.assert_allclose(mine[f], ref[f], rtol=1e-12, atol=0, err_msg=f"{f} {it}")
            for f in ("att_exc", "acc_exc", "att_mut", "acc_mut"):
                np.testing.assert_array_equal(mine[f], ref[f], err_msg=f"{f} {it}")
            np.testing.assert_array_equal(mine["history"], ref["history"])
            assert mine["swap_parity"] == int(ref["swap_parity"]) and mine["p2p"] == 1
        crossed = int(r["exchange"][-1]["acc_exc"][[1, 3]].sum())
    assert crossed > 0, "no swap across the rank boundary was accepted"


def test_whole_ladders_issue_no_collective(world2, world4):
    """A segment whose ladders are whole on every rank makes no collective
    call; a split ladder exchanges its boundary rows once an iteration and
    gathers the emitted rows once a sample."""
    _, ranks = world2
    for r in ranks:
        assert sum(r["segment_calls"]["whole"].values()) == 0
        for calls in (r["segment_calls"]["split"],) + tuple(w["segment_calls"] for w in world4):
            assert calls["exchange_boundary_rows"] == 3 * BASE["use_every_nth"]
            assert calls["all_gather_rows"] == 3
            assert calls["all_reduce_sum"] == calls["broadcast_object"] == calls["barrier"] == 0


def test_whole_ladders_merge_to_the_one_process_run(world2, whole_ref):
    """The JAX multiprocess test's run: each rank emits its own two
    ensembles, and the merged shards are the one-process run bit for bit;
    merge_shards writes them into an output.nc that the R-side loader
    reads back."""
    d, ranks = world2
    ref = whole_ref
    runs = [r["runs"]["whole"] for r in ranks]
    assert [r["ensemble_shard"] for r in runs] == [(0, 2), (2, 2)]
    assert all(r["adaptation_boundaries"] == 1 for r in runs)
    merged = merge_sharded_results([dict(r, temperatures=None) for r in runs])
    _assert_same_run(dict(merged, acceptance=runs[0]["acceptance"],
                          evaluations=runs[1]["evaluations"]), ref)

    out_nc = os.path.join(d, "output.nc")
    assert merge_main([os.path.join(d, f"samples_shard{r}.npz") for r in range(2)]
                      + ["-o", out_nc]) == 0
    for fn in ("prior.xml", "likelihood.xml"):
        shutil.copy(os.path.join(entry.BANANA, fn), os.path.join(d, fn))
    post = hdf5r_compat.bcm3_load_results(d, ".", output_filename="output.nc",
                                          load_sampler_adaptation=False)
    N, L, D = merged["samples"].shape
    assert post["posterior"]["samples"].shape == (D, L, N)
    np.testing.assert_array_equal(post["posterior"]["samples"][:, -1, :],
                                  merged["samples"][:, -1, :].T)
    np.testing.assert_array_equal(post["posterior"]["llikelihood"][-1, :],
                                  merged["log_likelihood"][:, -1])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_split_ladder_runs_equal_the_one_process_run_2_ranks(world2, scheme):
    _, ranks = world2
    ref = _run(**dict(SPLIT[2], swapping_scheme=scheme))
    for r in ranks:
        assert r["runs"][f"split_{scheme}"]["ensemble_shard"] is None
        _assert_same_run(r["runs"][f"split_{scheme}"], ref)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_split_ladder_runs_equal_the_one_process_run_4_ranks(world4, scheme):
    ref = _run(**dict(SPLIT[4], swapping_scheme=scheme))
    for r in world4:
        _assert_same_run(r["runs"][scheme], ref)


def test_clustered_autoblock_boundary_equals_the_one_process_run(world2):
    """Clustered proposals with clustered_autoblock blocking, one boundary
    (the gathered T=1 history clustered and re-blocked on every rank)."""
    _, ranks = world2
    ref = _run(**CLUSTERED)
    assert ref["adaptation_boundaries"] == 1
    for r in ranks:
        _assert_same_run(r["runs"]["clustered"], ref)


def test_checkpoints_resume_across_sharding(world2):
    """Sharded A (up to the boundary, checkpointed) then sharded B resumed
    from it equals the uninterrupted unsharded run U; an unsharded run
    resumed from the sharded checkpoint, and a sharded run resumed from an
    unsharded one, equal U's tail too."""
    d, ranks = world2
    U = _run(**CHECKPOINTED)
    tail = {k: U[k][len(U[k]) // 2 :] for k in KEYS}
    unsharded_b = _run(**dict(CHECKPOINTED, checkpoint_file=os.path.join(d, "sharded_a.ckpt")))
    for r in ranks:
        both = {k: np.concatenate([r["ckpt_a"][k], r["ckpt_b"][k]]) for k in KEYS}
        _assert_same_run(dict(both, acceptance=r["ckpt_b"]["acceptance"],
                              evaluations=r["ckpt_b"]["evaluations"]), U)
        for res in (r["ckpt_from_unsharded"], unsharded_b):
            _assert_same_run(res, dict(U, **tail))


def test_handlers_receive_the_whole_population_under_per_rank_emission(world2, whole_ref):
    """Each rank returns its own ensembles, and the primary's handler
    receives every rank's rows in the one-process run's order (the other
    ranks' handlers receive none); resumed from a checkpoint, the primary's
    handler is set to the whole population's row and receives the rest."""
    _, ranks = world2
    ref = whole_ref
    E = WHOLE["num_ensembles"]
    for rank, r in enumerate(ranks):
        own = r["handled"]
        assert own["ensemble_shard"] == (2 * rank, 2)
        for k in KEYS:
            np.testing.assert_array_equal(own[k], r["runs"]["whole"][k], err_msg=k)
    for key, start in (("handled", 0), ("handled_resumed", 20)):
        primary, other = ranks[0][key], ranks[1][key]
        assert other["handled"] is None and other["position"] is None
        assert primary["position"] == (start * E if start else None)
        for k in KEYS:
            np.testing.assert_array_equal(primary["handled"][k], ref[k][start * E:], err_msg=k)


def test_refusals(world2):
    """An indivisible population and mesh_devices below the world size are
    refused with a ValueError that says why."""
    _, ranks = world2
    for r in ranks:
        assert "divisible" in r["indivisible"]
        assert "mesh_devices" in r["mesh_devices"]


# ---------------------------------------------------------------------------
# The entry points (__graft_entry__.py's counterparts)


def test_dryrun_multichip_on_two_cpu_ranks():
    res = entry.dryrun_multichip(2, device="cpu")
    assert res["samples"].shape == (8 * 2, 4, 2) and res["evaluations"] > 0
    assert np.isfinite(res["samples"]).all()


def test_dryrun_multichip_refuses_missing_cards():
    """On "cuda" with fewer cards than ranks the dry run raises; it never
    moves to the CPU by itself."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="cards"):
        entry.dryrun_multichip(cards + 1)


def test_entry_step_is_one_iteration():
    step, (state, proposals) = entry.entry(device="cpu")
    x, lprior, llh = step(state, proposals)
    s = entry._sampler("cpu", **entry.ENTRY_CONFIG)
    ref, _ = s._iteration(s._init_state(), list(s.proposals), s.draw(s.proposals))
    for a, b in ((x, ref.x), (lprior, ref.lprior), (llh, ref.llh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert x.shape == (6, 2) and bool(torch.isfinite(lprior + llh).all())
