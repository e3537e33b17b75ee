"""The port's fleet lifecycle against the JAX fleet, on the CPU: stacked
versus shard-by-shard ticks for all four methods, live promotion
(dense→dense and sparse→dense), compaction under a staged tick,
kill / WAL / recover from the in-memory base and from disk, and whole
fleets saved by either package and restored by the other.

The same numpy graphs and deltas go through `repro.fleet.FingerFleet`
(its kernel methods in interpret mode) and the port's fleet on the
CPU. Port against reference: scores at atol 1e-5 with rtol 1e-5, as
divergences where those are below 1e-3 (`_torch_fleet.assert_scores`);
placements, layouts and the directory JSON exactly, its float
``last_score`` at the score tolerance. Stacked against shard by shard
within the port: bit for bit, scores and every shard's state — each
stream's row is ticked by the same code whatever the stacking.
"""
import json
import shutil

import numpy as np
import pytest

import repro.fleet as jfleet
import repro_torch.fleet as tfleet
from _torch_fleet import (Pair, assert_scores, edge, graph, two_buckets,
                          weights)
from repro_torch.fleet import FingerFleet, RecoveryError, ShardUnavailableError

METHODS = ("dense", "compact", "fused_tick", "sparse_tick")


def _rand_edge(rng, n, n_nodes=None):
    i, j = sorted(rng.choice(n, 2, replace=False).tolist())
    return dict(senders=[i], receivers=[j],
                dw=[float(rng.uniform(0.5, 2.0))], w_old=[0.0],
                n_nodes=n if n_nodes is None else n_nodes, k_pad=4,
                j_pad=2)


def _dense_lifecycle(pair, sizes):
    """The reference's `TestStackedSequentialParity._lifecycle`: admit →
    ticks → cross-bucket promotion → staged-tick compaction →
    save/restore → shard kill + WAL tick + recovery (the last three in
    `_run_lifecycle`). Returns the port's score trace and its launches
    in a steady-state tick."""
    names = list(sizes)
    trace = []

    def tick(seed):
        trace.append(pair.tick({n: edge(sizes[n], seed + k)
                                for k, n in enumerate(names)},
                               f"seed {seed}")[0])

    for i, n in enumerate(names):
        pair.admit(n, weights(sizes[n], i + 61))
    for t in range(3):
        tick(40 + 10 * t)
    steady = pair.t.last_poll_launches
    pair.both(lambda f, m: f.promote("a"))
    tick(80)
    pair.ingest({n: edge(sizes[n], 90 + k) for k, n in enumerate(names)})
    ja, ta = pair.both(lambda f, m: f.rebalance())
    assert any(a["action"] == "compact" for a in ta)
    assert ja is None or ta == ja
    pair.poll()
    trace.append(pair.check("across the compaction")[0])
    return trace, steady


def _sparse_lifecycle(pair, rng):
    """The reference's `_sparse_lifecycle`: sparse-pool ticks, live
    sparse → dense promotion, then (after the caller's save/restore) a
    sparse shard kill, a WAL-only tick and disk-base recovery."""
    names = ["u", "v", "w"]
    for i, n in enumerate(names):
        pair.admit(n, weights(8, i + 71))
    assert all(pair.t.directory.get(n).pool == 0 for n in names)
    trace = []
    for _ in range(3):
        trace.append(pair.tick({n: _rand_edge(rng, 8, 24) for n in names},
                               "sparse tick")[0])
    steady = pair.t.last_poll_launches
    pair.both(lambda f, m: f.promote("u"))
    assert pair.t.directory.get("u").pool == 1
    trace.append(pair.tick({n: _rand_edge(rng, 8, 24) for n in names},
                           "after promotion")[0])
    return trace, steady


def _sparse_cfg(stacked, root):
    return lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name="slots", n_pad=24, shards=2, streams_per_shard=2,
                   k_pad=4, j_pad=2, method="sparse_tick", n_slots=12,
                   m_pad=24),
        m.PoolSpec(name="big", n_pad=64, shards=1, streams_per_shard=2,
                   k_pad=4, j_pad=2),
    ), stacked_ticks=stacked, directory=str(
        root / ("jax" if m is jfleet else "port")))


def _run_lifecycle(method, stacked, root, jax):
    """One whole lifecycle of ``method`` with ``stacked_ticks``; the
    reference runs beside the port when ``jax``."""
    if method == "sparse_tick":
        make = _sparse_cfg(stacked, root)
        pair = Pair(make, jax=jax)
        rng = np.random.default_rng(13)
        names = ["u", "v", "w"]
        trace, steady = _sparse_lifecycle(pair, rng)

        def tick(label):
            trace.append(pair.tick({n: _rand_edge(rng, 8, 24)
                                    for n in names}, label)[0])
    else:
        sizes = {"a": 5, "b": 6, "c": 18}
        make = lambda m: two_buckets(  # noqa: E731
            m, method=method, compact_occupancy=0.95, stacked_ticks=stacked,
            directory=str(root / ("jax" if m is jfleet else "port")))
        pair = Pair(make, jax=jax)
        trace, steady = _dense_lifecycle(pair, sizes)
        seeds = iter(range(100, 200, 10))

        def tick(label):
            seed = next(seeds)
            trace.append(pair.tick({n: edge(sizes[n], seed + k)
                                    for k, n in enumerate(sizes)},
                                   label)[0])
    pair.both(lambda f, m: f.save())
    pair.close()
    pair = Pair(make, restore=True, jax=jax)
    try:
        tick("restored")
        victim = "v" if method == "sparse_tick" else "b"
        pool = "slots" if method == "sparse_tick" else "small"
        shard = pair.t.directory.get(victim).shard
        pair.both(lambda f, m: f.kill_shard(pool, shard))
        tick("WAL-only")
        jr, tr = pair.both(lambda f, m: f.recover())
        assert jr is None or tr == jr
        trace.append(pair.check("recovered")[0])
        tick("after recovery")
        jt, tt = pair.both(lambda f, m: f.top_anomalies(k=3))
        assert jt is None or [n for n, _ in tt] == [n for n, _ in jt]
        trace.append(dict(tt))
        return trace, pair.state_bits(), steady
    finally:
        pair.close()


@pytest.mark.parametrize("method", METHODS)
def test_stacked_and_shard_by_shard_lifecycles(method, tmp_path):
    """The lifecycle with ``stacked_ticks`` on matches the JAX fleet's
    (checked at every tick inside the run), and is bit-equal to the
    port's own run with ``stacked_ticks=False``: scores at every step
    and every shard's final state."""
    stacked, bits, launches = _run_lifecycle(method, True, tmp_path / "on",
                                             jax=True)
    seq, seq_bits, seq_launches = _run_lifecycle(method, False,
                                                 tmp_path / "off", jax=False)
    assert len(stacked) == len(seq)
    for i, (a, b) in enumerate(zip(stacked, seq)):
        assert a == b, (method, i, a, b)
    assert bits.keys() == seq_bits.keys()
    for k in bits:
        np.testing.assert_array_equal(bits[k], seq_bits[k], str(k))
    # steady state: one launch a pool against one a live shard
    assert launches == 2 and seq_launches == (3 if method == "sparse_tick"
                                              else 4)


def test_sparse_promotion_keeps_the_dense_oracle_trajectory():
    """The reference's `TestSparsePool`: a sparse bucket at parity, then
    a live sparse → dense promotion through the stream's SlotMap."""
    cfg = lambda m: m.FleetConfig(pools=(  # noqa: E731
        m.PoolSpec(name="slots", n_pad=64, shards=1, streams_per_shard=2,
                   k_pad=4, j_pad=2, method="sparse_tick", n_slots=12,
                   m_pad=24),
        m.PoolSpec(name="wide", n_pad=128, shards=1, streams_per_shard=2,
                   k_pad=4, j_pad=2)))
    pair = Pair(cfg)
    rng = np.random.default_rng(5)
    try:
        for i, n in enumerate(["u", "v"]):
            pair.admit(n, weights(8, i + 41))
        assert pair.t.directory.get("u").pool == 0
        for t in range(3):
            pair.tick({n: _rand_edge(rng, 8, 64) for n in "uv"}, f"tick {t}")
        jr, tr = pair.both(lambda f, m: f.promote("u"))
        assert tr == jr
        e = pair.t.directory.get("u")
        assert e.pool == 1 and e.slot_of_node is not None
        np.testing.assert_array_equal(
            e.base_state["strengths"],
            pair.j.directory.get("u").base_state["strengths"])
        for t in range(2):
            pair.tick({n: _rand_edge(rng, 8, 64) for n in "uv"},
                      f"promoted tick {t}")
    finally:
        pair.close()


def test_kill_wal_recover_from_the_in_memory_base():
    """The reference's `TestRecovery`: WAL-only ticks while dead, then a
    rebuild (base ⊕ replay) on the survivor that lands on the
    reference's score."""
    sizes = {"a": 5, "b": 7, "c": 20}
    pair = Pair(lambda m: two_buckets(m))
    try:
        for i, n in enumerate(sizes):
            pair.admit(n, weights(sizes[n], i + 21))
        for t in range(2):
            pair.tick({n: edge(sizes[n], 500 + 10 * t + k)
                       for k, n in enumerate(sizes)}, f"tick {t}")
        dead = pair.t.kill_shard("small", 0)
        pair.j.kill_shard("small", 0)
        assert dead.pool == 0 and pair.t.live_shards()[0] == [1]
        with pytest.raises(ShardUnavailableError, match="dead"):
            pair.t.shard_service(0, 0)
        stale = pair.t.scores()["a"]
        pair.tick({n: edge(sizes[n], 600 + k) for k, n in enumerate(sizes)},
                  "dead", names=["b", "c"])
        assert pair.t.scores()["a"] == stale
        jr, tr = pair.both(lambda f, m: f.recover())
        assert tr == jr and [r["tenant"] for r in tr] == ["a"]
        pair.check("recovered")
        pair.tick({n: edge(sizes[n], 700 + k) for k, n in enumerate(sizes)},
                  "after recovery")
    finally:
        pair.close()


def test_recovery_without_base_or_checkpoint_is_named():
    cfg = tfleet.FleetConfig(pools=(
        tfleet.PoolSpec(name="tiny", n_pad=8, shards=2, streams_per_shard=2,
                        k_pad=3, j_pad=2),))
    with FingerFleet.open(cfg, device="cpu") as fleet:
        fleet.admit("a", graph(tfleet, weights(4, 1)))
        fleet.directory.get("a").base_state = None
        fleet.kill_shard("tiny", 0)
        with pytest.raises(RecoveryError, match="checkpoint"):
            fleet.recover()


def _mixed_cfg(root):
    """A dense bucket and a sparse one, persisted under ``root``."""
    return lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name="small", n_pad=8, shards=2, streams_per_shard=2,
                   k_pad=4, j_pad=2),
        m.PoolSpec(name="slots", n_pad=64, shards=1, streams_per_shard=2,
                   k_pad=4, j_pad=2, method="sparse_tick", n_slots=16,
                   m_pad=64)), directory=str(root), compact_occupancy=0.9)


def _manifest(root):
    return json.loads((root / "fleet.json").read_text())


def _assert_manifests_equal(got, want):
    """``fleet.json`` key for key; ``last_score`` at the score
    tolerance."""
    assert got.keys() == want.keys()
    assert got["step"] == want["step"] and got["pools"] == want["pools"]
    assert [t["name"] for t in got["tenants"]] == \
        [t["name"] for t in want["tenants"]]
    for g, w in zip(got["tenants"], want["tenants"]):
        assert g.keys() == w.keys()
        assert_scores({"s": g.pop("last_score")},
                      {"s": w.pop("last_score")}, g["name"])
        assert g == w


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_checkpoints_cross_packages(writer, tmp_path):
    """A fleet (dense and sparse buckets) saved by one package restores
    in the other: the reader continues on the writer's trajectory,
    compacts the dense shards (journaled beside the writer's
    checkpoints), and recovers a dead shard from the writer's
    checkpoint walked through that journal; both packages write the
    same ``fleet.json``."""
    sizes = {"a": 5, "b": 6, "c": 10, "d": 12}
    pair = Pair(lambda m: _mixed_cfg(tmp_path / (
        "jax" if m is jfleet else "port"))(m))
    rng = np.random.default_rng(29)
    try:
        for i, n in enumerate(sizes):
            pair.admit(n, weights(sizes[n], i + 81))
        assert [pair.t.directory.get(n).pool for n in sizes] == [0, 0, 1, 1]
        for t in range(3):
            pair.tick({n: _rand_edge(rng, sizes[n], 64 if sizes[n] > 8
                                     else None) for n in sizes}, f"tick {t}")
        pair.both(lambda f, m: f.save())
        _assert_manifests_equal(_manifest(tmp_path / "port"),
                                _manifest(tmp_path / "jax"))
    finally:
        pair.close()
    # the reader restores the writer's directory (a copy each), and the
    # writer restores its own: both continue on one trajectory
    written = tmp_path / "written"
    shutil.copytree(tmp_path / writer, written)
    for name in ("jax", "port"):
        shutil.rmtree(tmp_path / name)
        shutil.copytree(written, tmp_path / name)
    pair = Pair(lambda m: _mixed_cfg(tmp_path / (
        "jax" if m is jfleet else "port"))(m), restore=True)
    try:
        assert pair.t.step == pair.j.step == 3
        pair.check("restored")
        ja, ta = pair.both(lambda f, m: f.rebalance())
        assert ta == ja and len(ta) == 2
        for t in range(2):
            pair.tick({n: _rand_edge(rng, sizes[n], 64 if sizes[n] > 8
                                     else None) for n in sizes},
                      f"restored tick {t}")
        shard = pair.t.directory.get("a").shard
        pair.both(lambda f, m: f.kill_shard("small", shard))
        pair.tick({n: _rand_edge(rng, sizes[n], 64 if sizes[n] > 8
                                 else None) for n in sizes}, "dead",
                  names=[n for n in sizes if n != "a"])
        jr, tr = pair.both(lambda f, m: f.recover())
        assert tr == jr
        pair.check("recovered from the writer's checkpoint")
    finally:
        pair.close()
