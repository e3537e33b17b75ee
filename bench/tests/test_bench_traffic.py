"""The delta cycle: exact w_old, the graph back at its start after each
cycle, distinct pairs in a forward half, the mix's proportions, the
streams an active share leaves sending, and generation that does not
depend on which streams share a block."""
import numpy as np
import pytest
import torch

from bench import graphs, spec, traffic
from bench.tests.tiny import GRAPH

K_PAD, J_PAD = 8, 4


def _mix(active_share=None):
    mix = spec.load_mix("steady")
    if active_share is not None:
        mix["active_share"] = active_share
    return mix


def _block(seed, b=6, graph=GRAPH, mix=None):
    mix = mix or _mix()
    streams = torch.arange(b, dtype=torch.int64)
    keys, offsets, w = graphs.edges(graph, seed, streams)
    d = traffic.block_deltas(mix, graph, seed, streams, keys, offsets, w,
                             K_PAD, J_PAD)
    return mix, keys, offsets, w, {f: v.numpy() for f, v in d.items()}


def _graph_dicts(keys, offsets, w, seed, b, graph=GRAPH):
    row, lo, hi = graphs.split_keys(keys)
    out = []
    n_live = graphs.n_live(graph, seed, torch.arange(b)).tolist()
    for r in range(b):
        sel = (row == r).numpy()
        edges = {(int(a), int(c)): float(x) for a, c, x in
                 zip(lo.numpy()[sel], hi.numpy()[sel], w.numpy()[sel])}
        out.append((edges, set(range(n_live[r]))))
    return out


@pytest.mark.parametrize("active_share", [None, 0.25])
@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 7, 2**33 + 1])
def test_cycle_is_exact_and_returns_every_graph_to_its_start(seed,
                                                             active_share):
    b = 6
    mix, keys, offsets, w, d = _block(seed, b, mix=_mix(active_share))
    start = _graph_dicts(keys, offsets, w, seed, b)
    for r in range(b):
        edges, live = dict(start[r][0]), set(start[r][1])
        for t in range(traffic.period(mix)):
            ids, flags = d["node_ids"][t, r], d["node_flag"][t, r]
            touched = {int(n) for n, f in zip(ids, flags) if f != 0}
            for n, f in zip(ids, flags):
                if f > 0:
                    assert int(n) not in live
                    live.add(int(n))
            for lane in range(K_PAD):
                if d["mask"][t, r, lane] == 0:
                    continue
                a, c = int(d["senders"][t, r, lane]), \
                    int(d["receivers"][t, r, lane])
                assert a != c and a in live and c in live
                assert not {a, c} & touched
                old = edges.get((a, c), 0.0)
                assert d["w_old"][t, r, lane] == old
                new = old + float(d["dw"][t, r, lane])
                assert new >= 0.0
                edges[(a, c)] = new
            for n, f in zip(ids, flags):
                if f < 0:
                    assert int(n) in live
                    assert not any(int(n) in pair and x > 0
                                   for pair, x in edges.items())
                    live.discard(int(n))
        assert {p: x for p, x in edges.items() if x > 0} == start[r][0]
        assert live == start[r][1]


def test_a_forward_half_touches_each_pair_once():
    mix, _, _, _, d = _block(99, 8)
    p = int(mix["cycle_ticks"])
    for r in range(8):
        m = d["mask"][:p, r] > 0
        pairs = list(zip(d["senders"][:p, r][m], d["receivers"][:p, r][m]))
        assert len(pairs) == len(set(pairs))


def _sending(d):
    """(period, B): whether each stream sends a non-empty delta."""
    return (d["mask"] > 0).any(-1) | (d["node_flag"] != 0).any(-1)


def test_an_active_share_of_one_is_the_mix_without_the_key():
    _, _, _, _, without = _block(31, 12)
    _, _, _, _, one = _block(31, 12, mix=_mix(1.0))
    for f in without:
        assert np.array_equal(without[f], one[f]), f
    assert _sending(without).all()


def test_an_active_share_leaves_the_others_empty_and_their_inverses_too():
    b = 400
    mix, _, _, _, full = _block(2024, b)
    _, _, _, _, d = _block(2024, b, mix=_mix(1 / 16))
    p = int(mix["cycle_ticks"])
    sending = _sending(d)
    assert 0.045 < sending[:p].mean() < 0.08
    # the inverse of forward tick t is tick 2p - 1 - t: the same streams
    assert np.array_equal(sending[p:], sending[:p][::-1])
    # a stream that sends, sends the steady mix's lanes, and those that
    # the steady mix dropped as repeats of a tick the share left empty
    on = sending[:p]
    kept = full["mask"][:p][on] > 0
    assert (d["mask"][:p][on][kept] > 0).all()
    for f in ("senders", "receivers", "dw", "w_old"):
        assert np.array_equal(d[f][:p][on][kept], full[f][:p][on][kept]), f
    off = ~sending
    assert not d["mask"][off].any() and not d["node_flag"][off].any()


def test_weights_and_changes_are_multiples_of_the_quantum():
    _, _, _, w, d = _block(5, 4)
    q = graphs.WEIGHT_QUANTUM
    for x in (w.numpy(), d["dw"], d["w_old"]):
        assert np.all(np.round(x / q) * q == x)


def test_the_mix_proportions():
    b = 400
    mix, keys, offsets, w, d = _block(2024, b)
    p = int(mix["cycle_ticks"])
    live = d["mask"][:p] > 0
    lanes = live.sum(-1)
    assert lanes.max() <= 8 and (lanes >= 1).mean() > 0.97
    assert 2.8 < lanes.mean() < 3.5
    assert 0.1 < (lanes == 8).mean() < 0.18
    existing = live & (d["w_old"][:p] > 0)
    assert 0.45 < existing.sum() / live.sum() < 0.55
    deleted = existing & (d["dw"][:p] == -d["w_old"][:p])
    assert 0.15 < deleted.sum() / existing.sum() < 0.25
    added = live & (d["w_old"][:p] == 0) & (d["dw"][:p] > 0)
    assert 0.15 < added.sum() / (live & ~existing).sum() < 0.25
    joins = d["node_flag"][:p, :, 0] > 0
    toggles = d["node_flag"][:p, :, 1] < 0
    assert 0.07 < joins.mean() < 0.13
    assert 0.16 < toggles.mean() < 0.24


def test_a_few_streams_and_the_hubs_take_more_of_the_changes():
    b = 400
    mix, keys, offsets, w, d = _block(2024, b)
    p = int(mix["cycle_ticks"])
    live = d["mask"][:p] > 0
    per_stream = np.sort(live.sum((0, 2)))[::-1]
    assert per_stream[:b // 10].sum() / per_stream.sum() > 0.18
    existing = live & (d["w_old"][:p] > 0)
    t, r, lane = np.nonzero(existing)
    key = graphs.pair_key(torch.as_tensor(r), torch.as_tensor(
        d["senders"][t, r, lane]), torch.as_tensor(d["receivers"][t, r, lane]))
    at = torch.searchsorted(keys, key) - offsets[r]
    share = (at.double() / (offsets[r + 1] - offsets[r]).double()).numpy()
    # edge_skew 2: the first tenth of a row's sorted edges, its hubs',
    # takes about sqrt(0.1) of the changes of existing edges
    assert 0.25 < (share < 0.1).mean() < 0.37


def test_a_stream_is_the_same_alone_or_in_a_block():
    keys, offsets, w = graphs.edges(GRAPH, 7, torch.arange(5))
    for s in (0, 3):
        alone = graphs.stream_graph(GRAPH, 7, s)
        k = keys[offsets[s]:offsets[s + 1]]
        _, lo, hi = graphs.split_keys(k)
        assert torch.equal(alone["lo"], lo) and torch.equal(alone["hi"], hi)
        assert torch.equal(alone["w"], w[offsets[s]:offsets[s + 1]])


def test_seeds_above_32_bits_give_other_graphs():
    a = graphs.edges(GRAPH, 5, torch.arange(2))[0]
    b = graphs.edges(GRAPH, 5 + (1 << 32), torch.arange(2))[0]
    assert not torch.equal(a, b)
