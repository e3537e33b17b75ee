"""The port's analysis gates on the card.

Every test here needs a CUDA device (`smem` reads CUDA's attributes of
the kernels' instantiations, the audit's sync check and the allocator's
segment count exist only there, and the ticks launch the hand-written
kernels), so on a machine without a card each skips by name. Run them
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_analysis.py
"""
import pytest
import torch

from repro_torch.analysis import sanitize, sentinel, smem, tick_audit
from repro_torch.kernels import dispatch
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.kernels.stream_tick import parity as st_parity
from repro_torch.serving.plans import build_plan

pytestmark = pytest.mark.cuda

INSTANTIATIONS = (
    {f"tick_kernel<{s}, {k}>" for s in ("false", "true")
     for k in (0, 2, 4, 8)}
    | {f"tick_kernel<false, {k}, true>" for k in (0, 2, 4, 8)}
    | {f"delta_stats_kernel<{k}>" for k in (0, 2, 4, 8)}
    | {"delta_stats_sorted_kernel", "vnge_q_kernel<true>",
       "vnge_q_kernel<false>", "bsr_matvec_kernel<128>",
       "bsr_matvec_kernel<64>", "graph_stats_kernel<true>",
       "graph_stats_kernel<false>"}
    | {f"row_stats_kernel<{v}, {b}>" for v in (1, 2, 4, 8)
       for b in ("true", "false")})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the analysis reads the card and "
                    "the ticks launch the hand-written kernels, which run "
                    "only on the card")
    dispatch.library()
    return torch.device("cuda")


def test_smem_report_is_clean_and_covers_every_instantiation(cuda):
    saved = sanitize.launch_counts()
    report = smem.run_smem(cuda)
    assert report.ok, [v.message for v in report.violations]
    assert {c.kernel for c in report.configs} == INSTANTIATIONS
    assert all(n > 0 for n in report.parity_launches.values())
    assert sanitize.launch_counts() == saved  # compare launches put back
    for c in report.configs:
        assert c.registers > 0 and c.max_threads >= c.block
        assert (c.blocks_per_sm > 0) == c.accepted, c
    assert len(report.guards) == 10 and all(
        g.guard_admits == g.kernel_accepts for g in report.guards)


def test_launch_attrs_agree_with_the_tick_residency(cuda):
    for name in ("stream_tick", "sparse_tick"):
        for k, j in ((128, 8), (1024, 8), (37, 3)):
            res = dispatch.residency(name, k, j)
            rec = dispatch.launch_attrs(name, 0, 1, k, j)
            assert rec["blocks_per_sm"] == res["blocks_per_sm"]
            assert rec["registers"] == res["registers"]
            assert rec["dyn_smem"] == dispatch.smem_bytes(name, k, j)
            assert rec["block"] == 32 * res["streams_per_block"]
    big = dispatch.launch_attrs("stream_tick", 0, 1, 1 << 14, 8)
    assert not big["accepted"] and big["blocks_per_sm"] == 0
    assert not dispatch.smem_fits("stream_tick", 1 << 14, 8, cuda)


def test_split_tick_launch_keeps_the_one_warp_launch(cuda):
    """W = 1 launches as before any split existed: at the cells' shapes,
    the phase 8 pool and a ragged k, the one-warp instantiation, grid,
    block and shared memory, with the 64 registers and 4 blocks an SM it
    read on the H100. W = 2, 4 and 8 take the split instantiation with
    the same block and shared memory over 8 / W streams a block,
    accepted within the card's limit; a W that does not divide a
    block's warps is refused."""
    for rows, k, j, kpl in ((524288, 8, 4, 2), (512, 8, 4, 2),
                            (4096, 128, 8, 8), (1000, 37, 3, 4)):
        res = dispatch.residency("stream_tick", k, j)
        one = dispatch.launch_attrs("stream_tick", 0, rows, k, j)
        assert dispatch.launch_attrs("stream_tick", 1, rows, k, j) == one
        assert (one["kernel"], one["grid"], one["block"], one["dyn_smem"]) \
            == (f"tick_kernel<false, {kpl}>", -(-rows // 8), 256,
                dispatch.smem_bytes("stream_tick", k, j))
        assert (one["registers"], one["blocks_per_sm"]) == (64, 4) \
            == (res["registers"], res["blocks_per_sm"])
        for w in (2, 4, 8):
            rec = dispatch.launch_attrs("stream_tick", w, rows, k, j)
            assert rec["accepted"], rec
            assert rec["static_smem"] + rec["dyn_smem"] <= rec["smem_limit"]
            assert (rec["kernel"], rec["grid"], rec["block"],
                    rec["dyn_smem"], rec["blocks_per_sm"]) == (
                f"tick_kernel<false, {kpl}, true>", -(-rows // (8 // w)),
                256, one["dyn_smem"], 4)
    for w in (3, 8):  # not a power of two; above a k = 1024 block's 4
        rec = dispatch.launch_attrs("stream_tick", w, 32, 1024, 8)
        assert not rec["accepted"] and rec["blocks_per_sm"] == 0


def test_audit_is_clean_on_the_card(cuda):
    report = tick_audit.audit_repo(cuda)
    assert report.ok, [v.message for v in report.violations]
    ticks = [t for t in report.targets if t.placement is not None]
    assert len(ticks) == 12
    for t in ticks:
        kernel = "stream_tick" if "fused_tick" in t.target else "sparse_tick"
        assert t.launches == {kernel: t.shards}, t.target


def test_audit_catches_a_sync_in_a_tick_on_the_card(cuda):
    config = tick_audit.service_config("local", "fused_tick")
    plan = build_plan(config, cuda)
    tick = plan.tick

    def seeded(states, deltas):
        dists, new = tick(states, deltas)
        torch.nonzero(dists)  # a data-dependent shape: a device sync
        return dists, new

    plan.tick = seeded
    t = tick_audit.audit_plan_tick(config, cuda, plan=plan)
    assert {v.rule for v in t.violations} == {"host-transfer-in-tick"}
    assert torch.cuda.get_sync_debug_mode() == 0


def test_no_transfers_on_the_card_refuses_and_restores(cuda):
    x = torch.arange(8.0, device=cuda)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with pytest.raises(sanitize.TransferBudgetExceeded,
                           match="_to_copy of a CUDA tensor"):
            with sanitize.no_transfers(cuda):
                x.cpu()
        assert torch.cuda.get_sync_debug_mode() == 1
        with pytest.raises(RuntimeError, match="synchroniz"):
            with sanitize.no_transfers(cuda):
                torch.nonzero(x)
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with sanitize.transfer_budget(None) as c:
        x.cpu()
        float(x.sum())
        torch.zeros(8).copy_(x)
    assert c.count == 3


def test_first_use_budget_counts_allocator_segments(cuda):
    torch.cuda.synchronize()
    with sanitize.first_use_budget(None, device=cuda) as c:
        big = torch.empty(1 << 28, device=cuda)  # 1 GiB: a new segment
    del big
    assert c.events["allocator_segment"] >= 1
    torch.cuda.empty_cache()


def test_debug_nan_checks_blames_the_kernel_launch(cuda):
    """A NaN only the kernel reads (a live lane's Δw) makes NaN strengths
    that no aten op made: the next op that reads them names the launch."""
    states, deltas = st_parity.make_case(64, 333, 37, 3, seed=0,
                                         device=cuda)
    deltas.dw[5, 0] = float("nan")  # row 5's lanes 0-5 are live
    with pytest.raises(sanitize.NanCheckError,
                       match="kernel launch before aten"):
        with sanitize.debug_nan_checks():
            st_ops.stream_tick_fused(states, deltas, inplace=True)
            states.strengths.sum()


@pytest.mark.parametrize("chain", ["run_migration_chain",
                                   "run_sparse_chain", "run_fleet_chain"])
def test_sentinel_chains_on_the_card(cuda, chain):
    torch.cuda.empty_cache()
    report = getattr(sentinel, chain)(device=cuda)
    assert report["ok"] and set(report["phases"].values()) == {0}


def test_scaled_chain_on_the_card_at_a_cut_size(cuda):
    torch.cuda.empty_cache()
    report = sentinel.run_scaled_chain(device=cuda, batch_size=4096)
    assert report["ok"] and set(report["phases"].values()) == {0}


def test_double_buffered_migration_pays_no_first_use(cuda):
    """A migration hands the new ingestor the old one's side stream and
    pinned slots: after the warm, ticks, a grow with a tick queued and a
    compaction use no new allocator segment, no cold plan."""
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

    config = ServiceConfig(batch_size=64, n_pad=64, k_pad=3,
                           method="fused_tick", ingestion="double_buffered",
                           topk=TopKSpec(k=2))
    graphs = [erdos_renyi(40 + s % 8, 0.2, seed=s, weighted=True)
              for s in range(64)]
    torch.cuda.empty_cache()
    with FingerService.open(config, graphs, device=cuda) as svc:
        def tick(n_pad, seed):
            svc.ingest(sentinel._tick_deltas(graphs, n_pad, seed))
            assert svc.poll() is not None

        for seed in range(4):  # every pinned slot and the plan used once
            tick(64, seed)
        side = svc._ingestor._stagers[0].side
        svc.warm_next_layouts([128])
        with sanitize.first_use_budget(0, "double-buffered repad",
                                       device=cuda) as c:
            svc.ingest(sentinel._tick_deltas(graphs, 64, 10))
            svc.repad(128)
            assert svc.poll() is not None
            for seed in range(11, 14):
                tick(128, seed)
        assert c.count == 0
        assert svc._ingestor._stagers[0].side is side
        svc.warm_next_layouts([64])
        with sanitize.first_use_budget(0, "double-buffered compact",
                                       device=cuda):
            svc.compact(64)
            for seed in range(20, 23):
                tick(64, seed)
        assert svc._ingestor._stagers[0].side is side


def test_smem_parity_rules_catch_a_silent_and_a_wrong_package(cuda,
                                                              monkeypatch):
    """A package whose parity case launches nothing is `no-launch`; one
    whose case disagrees with its plain version is `parity-mismatch`."""
    def wrong(dev, seed):
        smem.PARITY_RUNS["stream_tick"](dev, seed)
        raise AssertionError("seeded: not equal to the plain version")

    monkeypatch.setitem(smem.PARITY_RUNS, "vnge_q", lambda dev, seed: None)
    monkeypatch.setitem(smem.PARITY_RUNS, "bsr_spmv", wrong)
    launches, mismatches = smem.run_parity(cuda)
    assert launches["vnge_q"] == 0 and launches["bsr_spmv"] == 1
    assert [(v.rule, v.kernel) for v in mismatches] == [
        ("parity-mismatch", "bsr_spmv")]
    got = smem.check_launch_configs([], [], launches)
    assert [(v.rule, v.kernel) for v in got] == [("no-launch", "vnge_q")]
