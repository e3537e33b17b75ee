"""Graph-stream serving example on the port: B concurrent FINGER
streams behind one declarative `FingerService`, one JSdist anomaly score
per stream per tick.

The twin of `examples/serve_streams.py`, with its flags and printed
lines, on the card unless ``--device cpu``. The service's plan runs the
tick of ``--method``: ``fused_tick`` launches the ``stream_tick`` kernel
once a tick and ``sparse_tick`` the ``sparse_tick`` kernel (their plain
PyTorch versions on the CPU).

One stream gets a planted DoS-style fan-in burst halfway through; the
service's top-k query singles it out without gathering the full score
vector.

With ``--mixed-n`` the tenants are heterogeneous (per-stream node counts
cycle through {n/4, n/2, 3n/4, n}, embedded into one shared n_pad
layout). With ``--ckpt-dir`` the demo saves mid-run, simulates a serving
restart (`FingerService.restore`), and resumes scoring without
replaying a tick. ``--placement sharded`` serves the same loop split
over a `DeviceGrid` of 4 logical shards of the one device
(``multipod``: 2 pods × 2 shards).

``--compact-every N`` demos the layout lifecycle's slot reclamation:
each tick every stream's highest active node leaves (its edges deleted
and the slot deactivated in one delta), and every N ticks the service
runs `compact()`, dropping the permanently-left slots and printing the
migration pause. The synthesizer keeps addressing deltas in the
*original* layout throughout: the compaction's index map renumbers them
on ingest.

``--fleet`` switches to the multi-tenant `repro_torch.fleet` demo: a
2-bucket × 2-shard fleet admits named tenants by best-fit bucket,
promotes one to the big bucket mid-stream (warm: `fleet.warm()` first),
kills a shard and recovers its tenants onto survivors, and checks every
tenant's score against a single oracle `FingerService` fed the same
deltas after every tick.

    PYTHONPATH=src python examples_torch/serve_streams.py --streams 256 \
        --ticks 20 [--method fused_tick|sparse_tick] [--device cpu]
    PYTHONPATH=src python examples_torch/serve_streams.py --mixed-n \
        --ckpt-dir /tmp/streams_ckpt
    PYTHONPATH=src python examples_torch/serve_streams.py \
        --placement sharded --ingestion double_buffered
    PYTHONPATH=src python examples_torch/serve_streams.py --streams 64 \
        --ticks 20 --compact-every 5
    PYTHONPATH=src python examples_torch/serve_streams.py --fleet \
        --ticks 12
"""
import argparse
import time

import numpy as np

from repro_torch.distributed import make_grid
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serving import (
    CheckpointPolicy,
    FingerService,
    ServiceConfig,
    TopKSpec,
)

SHARDS = 4  # logical shards of the device under --placement sharded
PODS = (2, 2)  # pods x shards under --placement multipod


def placement_target(placement: str, config: ServiceConfig, dev) -> dict:
    """`FingerService.open`'s keyword for the placement: the device for
    ``local``, a grid of logical shards of it otherwise."""
    if placement == "sharded":
        return {"grid": make_grid((SHARDS,), (config.data_axis,), dev)}
    if placement == "multipod":
        return {"grid": make_grid(PODS, (config.pod_axis,
                                         config.data_axis), dev)}
    return {"device": dev}


def churn_delta(w: np.ndarray, rng, k: int, k_pad: int,
                iu: np.ndarray, ju: np.ndarray,
                n_pad: int, j_pad=None) -> GraphDelta:
    """Toggle k random node pairs (background churn for one stream).

    Mutates `w` in place — the host mirror stays current without a
    device round-trip per stream per tick. `iu`/`ju` are the stream's
    upper-triangle indices (hoisted out of the tick loop).
    """
    n = w.shape[0]
    pick = rng.choice(len(iu), size=min(k, len(iu)), replace=False)
    ii, jj = iu[pick], ju[pick]
    w_old = w[ii, jj]
    dw = np.where(w_old > 0, -w_old, 1.0).astype(np.float32)
    d = GraphDelta.from_arrays(ii, jj, dw, w_old, n_nodes=n, k_pad=k_pad,
                               n_pad=n_pad, j_pad=j_pad)
    w[ii, jj] += dw
    w[jj, ii] += dw
    return d


def dos_delta(w: np.ndarray, rng, frac: float, k_pad: int,
              n_pad: int, n_active=None, j_pad=None) -> GraphDelta:
    """Fan-in burst: frac·n nodes all connect to one target (in place)."""
    n = w.shape[0] if n_active is None else int(n_active)
    target = int(rng.integers(0, n))
    botnet = rng.choice(np.setdiff1d(np.arange(n), [target]),
                        size=max(1, int(frac * n)), replace=False)
    w_old = w[botnet, target]
    dw = (1.0 - w_old).astype(np.float32)
    keep = np.abs(dw) > 1e-12
    ii, jj = botnet[keep], np.full(int(keep.sum()), target)
    d = GraphDelta.from_arrays(ii, jj, dw[keep], w_old[keep],
                               n_nodes=w.shape[0],
                               k_pad=k_pad, n_pad=n_pad, j_pad=j_pad)
    w[ii, jj] += dw[keep]
    w[jj, ii] += dw[keep]
    return d


def leave_delta(w: np.ndarray, node: int, k_pad: int, n_pad: int,
                j_pad: int) -> GraphDelta:
    """The stream's node `node` leaves: delete its incident edges and
    deactivate the slot, in one delta (isolated-leave contract)."""
    nb = np.nonzero(w[node])[0]
    d = GraphDelta.from_arrays(
        np.full(len(nb), node), nb, -w[node, nb], w[node, nb],
        n_nodes=w.shape[0], k_pad=k_pad, n_pad=n_pad,
        leave=[node], j_pad=j_pad)
    w[node, :] = 0.0
    w[:, node] = 0.0
    return d


def fleet_demo(ticks: int, dev) -> dict:
    """Multi-tenant fleet lifecycle: admit → serve → warm promotion →
    shard kill → WAL-only ticks → recovery, scored against a single
    oracle service after every tick. Returns the last tick's worst
    oracle gap and whether it held (``ok``)."""
    from repro_torch.fleet import FingerFleet, FleetConfig, PoolSpec
    from repro_torch.serving.migrate import embed_delta

    k_pad, j_pad = 4, 2
    cfg = FleetConfig(pools=(
        PoolSpec(name="small", n_pad=16, shards=2, streams_per_shard=2,
                 k_pad=k_pad, j_pad=j_pad),
        PoolSpec(name="large", n_pad=48, shards=2, streams_per_shard=2,
                 k_pad=k_pad, j_pad=j_pad),
    ))
    rng = np.random.default_rng(7)
    names = ["alpha", "beta", "gamma", "delta"]
    sizes = {"alpha": 10, "beta": 8, "gamma": 12, "delta": 24}
    graphs = {n: erdos_renyi(sizes[n], 0.4, seed=i, weighted=True)
              for i, n in enumerate(names)}

    # The oracle: one FingerService fed every tenant's deltas in one
    # shared layout. The fleet must match it no matter how it shuffles
    # tenants between shards underneath.
    o_pad = cfg.pools[-1].n_pad
    oracle = FingerService.open(
        ServiceConfig(batch_size=len(names), n_pad=o_pad, k_pad=k_pad,
                      j_pad=j_pad, topk=TopKSpec(k=len(names))),
        [graphs[n] for n in names], device=dev)
    z = np.zeros((0,), np.float32)
    o_empty = GraphDelta.from_arrays(z, z, z, z, n_nodes=0, n_pad=o_pad,
                                     k_pad=k_pad, j_pad=j_pad)

    def tenant_delta(name):
        n = sizes[name]
        i, j = sorted(rng.choice(n, 2, replace=False).tolist())
        return GraphDelta.from_arrays(
            [i], [j], [float(rng.uniform(0.5, 5.0))], [0.0],
            n_nodes=n, k_pad=k_pad, j_pad=j_pad)

    def tick(fleet, live=None):
        ds = {n: tenant_delta(n) for n in (live or names)}
        fleet.ingest(ds)
        fleet.poll()
        oracle.ingest([embed_delta(ds[n], o_pad) if n in ds else o_empty
                       for n in names])
        oracle.poll()
        ref = np.asarray(oracle.scores()).ravel()
        got = fleet.scores()
        worst = max(abs(got[n] - float(ref[i]))
                    for i, n in enumerate(names) if n in got)
        return got, worst

    fleet = FingerFleet.open(cfg, device=dev)
    for n in names:
        e = fleet.admit(n, graphs[n])
        pool = cfg.pools[e.pool].name
        print(f"admit {n:6s} (n={sizes[n]:2d}) -> pool {pool!r} "
              f"shard {e.shard} slot {e.slot}")

    phase_ticks = max(2, ticks // 4)
    for _ in range(phase_ticks):
        _, worst = tick(fleet)
        print(f"tick {fleet.step:2d}: oracle |Δ|max = {worst:.2e}")

    # Warm promotion: pre-compile the rebalance surface, then move a
    # small-bucket tenant to the big bucket live, mid-stream.
    fleet.warm()
    tm = time.perf_counter()
    fleet.promote("alpha")
    pause = (time.perf_counter() - tm) * 1e3
    e = fleet.directory.get("alpha")
    print(f"promoted 'alpha' -> pool {cfg.pools[e.pool].name!r} shard "
          f"{e.shard} in {pause:.1f}ms (warm: plans pre-compiled)")
    for _ in range(phase_ticks):
        _, worst = tick(fleet)
        print(f"tick {fleet.step:2d}: oracle |Δ|max = {worst:.2e}")

    # Shard failure: the victim's tenants keep accumulating WAL while
    # the shard is dead, then recovery replays them onto survivors.
    victim = fleet.directory.get("beta")
    stranded = sorted(e.name for e in fleet.directory.tenants_on(
        victim.pool, victim.shard))
    fleet.kill_shard(cfg.pools[victim.pool].name, victim.shard)
    print(f"killed pool {cfg.pools[victim.pool].name!r} shard "
          f"{victim.shard} — stranded tenants: {stranded}")
    live = [n for n in names if n not in stranded]
    for _ in range(phase_ticks):
        got, _ = tick(fleet, live=None)  # stranded deltas go WAL-only
        # the oracle's scores are a host array already
        ref = np.asarray(oracle.scores()).ravel()  # lint: disable=per-item-host-sync
        worst = max(abs(got[n] - float(ref[i]))
                    for i, n in enumerate(names) if n in live)
        print(f"tick {fleet.step:2d}: oracle |Δ|max = {worst:.2e} "
              f"(live tenants only; {stranded} on WAL)")
    tm = time.perf_counter()
    reports = fleet.recover()
    rec_ms = (time.perf_counter() - tm) * 1e3
    for r in reports:
        p, s, slot = r["to"]
        print(f"recovered {r['tenant']!r} onto pool "
              f"{cfg.pools[p].name!r} shard {s} slot {slot} "
              f"(WAL replayed: {r['replayed']})")
    print(f"recovery took {rec_ms:.1f}ms for {len(reports)} tenant(s)")
    _, worst = tick(fleet)
    print(f"tick {fleet.step:2d}: oracle |Δ|max = {worst:.2e} "
          f"(all tenants, post-recovery)")

    top = fleet.top_anomalies(k=2)
    print("top_anomalies(2):",
          ", ".join(f"{n}={v:.4f}" for n, v in top))
    ok = worst < 1e-5
    print("PARITY OK" if ok else "PARITY DRIFT — exceeded 1e-5")
    fleet.close()
    oracle.close()
    return {"worst": worst, "ok": ok, "top": top}


def main(argv=None) -> dict:
    """Run the demo of ``argv``; return what it printed as values."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=128,
                    help="n_pad, the shared node layout size")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--churn", type=int, default=16, help="edges/tick")
    ap.add_argument("--dos-frac", type=float, default=0.25)
    ap.add_argument("--method", default="dense",
                    choices=["dense", "compact", "fused_tick",
                             "sparse_tick"],
                    help="update path; fused_tick runs the whole "
                         "batched tick as one launch of the stream_tick "
                         "kernel on the card (its plain PyTorch "
                         "version on the CPU); "
                         "sparse_tick serves the slot-space path "
                         "(the sparse_tick kernel): "
                         "--nodes becomes the VIRTUAL node bound "
                         "(millions are free) while device cost is set "
                         "by --n-slots/--m-pad only")
    ap.add_argument("--active-nodes", type=int, default=None,
                    help="sparse_tick: per-stream active graph size "
                         "(default min(--nodes, 128)); the rest of the "
                         "--nodes virtual space costs nothing")
    ap.add_argument("--n-slots", type=int, default=None,
                    help="sparse_tick: device node-slot capacity "
                         "(default: the largest active size)")
    ap.add_argument("--m-pad", type=int, default=None,
                    help="sparse_tick: device edge-slot capacity "
                         "(default: 2x the largest initial edge count "
                         "plus churn headroom)")
    ap.add_argument("--placement", default="local",
                    choices=["local", "sharded", "multipod"],
                    help="sharded: 4 logical shards of the device; "
                         "multipod: 2 pods x 2 shards")
    ap.add_argument("--ingestion", default="double_buffered",
                    choices=["sync", "double_buffered"])
    ap.add_argument("--mixed-n", action="store_true",
                    help="heterogeneous tenants: per-stream node counts "
                         "cycle through {n/4, n/2, 3n/4, n}")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save mid-run and resume from a simulated "
                         "serving restart")
    ap.add_argument("--compact-every", type=int, default=None,
                    help="every N ticks, compact() the layout: streams "
                         "shed their highest active node each tick and "
                         "the service reclaims the permanently-left "
                         "slots (deltas stay addressed in the original "
                         "layout — ingestion remaps them)")
    ap.add_argument("--fleet", action="store_true",
                    help="run the multi-tenant repro_torch.fleet demo "
                         "instead: "
                         "2-bucket x 2-shard fleet with admission, warm "
                         "mid-stream promotion, shard kill + recovery, "
                         "oracle parity after every tick")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.fleet:
        return fleet_demo(args.ticks, dev)

    b, n_pad = args.streams, args.nodes
    rng = np.random.default_rng(0)
    compacting = args.compact_every is not None
    sparse = args.method == "sparse_tick"
    if sparse and args.ckpt_dir:
        ap.error("--method sparse_tick is not checkpointable (the "
                 "host-side SlotMap assignments are part of the state)")
    if sparse and compacting:
        ap.error("--method sparse_tick has no compact(): freed slots "
                 "are reused by the SlotMap; grow_capacity() is the "
                 "sparse migration")
    j_pad = 1 if compacting else None

    # Under sparse_tick the tenants stay small (active-nodes) while
    # --nodes is only the virtual addressing bound; everything else
    # (churn, DoS, scoring) is identical.
    n_base = min(n_pad, args.active_nodes or 128) if sparse else n_pad
    if args.mixed_n:
        sizes = [max(8, n_base // 4), max(8, n_base // 2),
                 max(8, 3 * n_base // 4), n_base]
        ns = [sizes[s % len(sizes)] for s in range(b)]
    else:
        ns = [n_base] * b
    k_pad = max(args.churn, int(args.dos_frac * max(ns))) + 1
    if compacting:
        # a leaving node's whole incident edge set rides in one delta
        k_pad = max(k_pad, n_pad)
    attack_stream = int(rng.integers(0, b))
    attack_tick = args.ticks // 2

    graphs = [erdos_renyi(n, 0.08, seed=s, weighted=False)
              for s, n in enumerate(ns)]
    ws = [g.weights.numpy().copy() for g in graphs]
    triu = {n: np.triu_indices(n, k=1) for n in set(ns)}

    n_slots = m_pad = None
    if sparse:
        n_slots = args.n_slots or max(ns)
        m0 = max(int(np.count_nonzero(np.triu(w, 1))) for w in ws)
        m_pad = args.m_pad or 2 * (m0 + k_pad)
    config = ServiceConfig(
        batch_size=b, n_pad=n_pad, k_pad=k_pad, j_pad=j_pad,
        method=args.method, n_slots=n_slots, m_pad=m_pad,
        placement=args.placement,
        ingestion=args.ingestion,
        checkpoint=CheckpointPolicy(directory=args.ckpt_dir),
        topk=TopKSpec(k=1),
    )
    where = placement_target(args.placement, config, dev)
    service = FingerService.open(config, graphs, **where)
    if args.mixed_n:
        print(f"mixed-n tenants: n in {sorted(set(ns))}, "
              f"served at n_pad={n_pad} in one compiled tick")
    if sparse:
        print(f"sparse_tick: virtual n_pad={n_pad:,} served from "
              f"n_slots={n_slots} node slots + m_pad={m_pad} edge "
              "slots per stream (device cost is capacity-, not "
              "virtual-, sized)")

    restart_tick = args.ticks // 2 if args.ckpt_dir else None
    # Tenants shrink from the top: act[s] tracks the active prefix, so
    # churn/DoS target live nodes and leaves never create re-joins.
    act = list(ns)
    min_act = max(4, min(ns) // 4)

    def synthesize(t):
        deltas = []
        for s in range(b):
            iu, ju = triu[ns[s]]
            if compacting:
                sel = ju < act[s]
                iu, ju = iu[sel], ju[sel]
            if s == attack_stream and t == attack_tick:
                deltas.append(dos_delta(ws[s], rng, args.dos_frac, k_pad,
                                        n_pad=n_pad, n_active=act[s],
                                        j_pad=j_pad))
            elif compacting and t % 2 == 1 and act[s] > min_act:
                deltas.append(leave_delta(ws[s], act[s] - 1, k_pad,
                                          n_pad=n_pad, j_pad=j_pad))
                act[s] -= 1
            else:
                # churn proportional to the tenant's node-pair space, so
                # a small tenant's background churn is not an anomaly in
                # itself (edges live in O(n²) pair space). The reference
                # is the largest TENANT, not n_pad: under sparse_tick
                # the virtual bound is astronomically larger than any
                # tenant and would zero out all background churn.
                n_s = act[s] if compacting else ns[s]
                n_ref = max(ns)
                churn_k = max(1, args.churn * (n_s * (n_s - 1))
                              // (n_ref * (n_ref - 1)))
                deltas.append(churn_delta(ws[s], rng, churn_k, k_pad,
                                          iu, ju, n_pad=n_pad,
                                          j_pad=j_pad))
        return deltas

    scores = np.zeros((args.ticks, b), np.float32)
    t0 = time.time()
    for t in range(args.ticks):
        if restart_tick is not None and t == restart_tick:
            service.save()
            print(f"tick {t}: state checkpointed to {args.ckpt_dir}; "
                  "simulating serving restart...")
            cfg_now = service.config  # carries any migrated n_pad
            service.close()  # fresh process
            service = FingerService.restore(cfg_now,
                                            directory=args.ckpt_dir,
                                            **where)
            print(f"tick {t}: restored step={service.step} (layout "
                  f"generation {service.layout.generation}), resuming "
                  "without replaying any stream")
        if compacting and t > 0 and t % args.compact_every == 0:
            tm = time.perf_counter()
            report = service.compact()
            pause_ms = (time.perf_counter() - tm) * 1e3
            if report.reclaimed:
                print(f"tick {t}: compact() reclaimed "
                      f"{report.reclaimed} slot(s) — n_pad "
                      f"{report.old_n_pad}→{report.new_n_pad}, layout "
                      f"generation {report.generation}, pause "
                      f"{pause_ms:.1f}ms (deltas keep addressing the "
                      f"original {n_pad}-slot layout; ingestion remaps)")
        service.ingest(synthesize(t))
        service.poll()
        scores[t] = service.scores()
    dt = time.time() - t0
    top_val, top_id = service.top_anomalies(1)
    service.close()

    flagged_tick, flagged_stream = np.unravel_index(scores.argmax(),
                                                    scores.shape)
    rate = args.ticks * b / dt
    print(f"served {b} streams x {args.ticks} ticks in {dt:.2f}s "
          f"({rate:.0f} stream-ticks/s incl. host delta synthesis; "
          f"placement={args.placement}, ingestion={args.ingestion})")
    print(f"planted DoS: stream {attack_stream} at tick {attack_tick}")
    print(f"top score  : stream {flagged_stream} at tick {flagged_tick} "
          f"(JSdist {scores[flagged_tick, flagged_stream]:.4f}; "
          f"background median {np.median(scores):.4f})")
    print(f"final-tick top_anomalies(1): stream {int(top_id[0])} "
          f"(JSdist {float(top_val[0]):.4f}, sharded query — no full "
          "score gather)")
    hit = (flagged_stream == attack_stream and flagged_tick == attack_tick)
    print("DETECTED" if hit else "MISSED")
    return {"scores": scores, "attack": (attack_stream, attack_tick),
            "flagged": (int(flagged_tick), int(flagged_stream)),
            "top": (float(top_val[0]), int(top_id[0])), "hit": bool(hit)}


if __name__ == "__main__":
    main()
