"""The port's fleet on the card: the pool-stacked tick through the
stacked `stream_tick` / `sparse_tick` kernels.

Every test here needs a CUDA device (the stacked ticks launch the
hand-written kernels, which have no interpret mode), so on a machine
without a card each skips by name. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fleet.py

Within the card, a stacked fleet and the same fleet ticked shard by
shard (``stacked_ticks=False``) must agree bit for bit: each warp of
the kernel ticks one stream whatever the grid. The card's fleet is held
to the same fleet on the CPU (the plain versions) at atol 1e-5 with
rtol 1e-5, scores as divergences where those are below 1e-3.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitize import no_transfers
from repro_torch.fleet import FingerFleet, FleetConfig, PoolSpec
from repro_torch.graphs.types import EdgeList, GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.stream_tick import ops as st_ops

pytestmark = pytest.mark.cuda

N_PAD, B, K, J = 64, 64, 16, 2
N_VIRT, SP_B, SLOTS, M_PAD = 1 << 16, 32, 64, 256
FUSED_SHARDS, SPARSE_SHARDS = 3, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet's stacked ticks launch "
                    "the hand-written kernels, which run only on the card")
    return torch.device("cuda")


def _config(stacked=True, **kw):
    return FleetConfig(pools=(
        PoolSpec(name="dense", n_pad=N_PAD, shards=FUSED_SHARDS,
                 streams_per_shard=B, k_pad=K, j_pad=J, method="fused_tick",
                 exact_smax=True),
        PoolSpec(name="virtual", n_pad=N_VIRT, shards=SPARSE_SHARDS,
                 streams_per_shard=SP_B, k_pad=K, j_pad=J,
                 method="sparse_tick", n_slots=SLOTS, m_pad=M_PAD,
                 exact_smax=True)), stacked_ticks=stacked, **kw)


class Tenants:
    """Seeded tenants: dense ones of 30, 34 or 38 nodes (by admission
    order, so each fused shard holds one size) and sparse ones of 40
    active ids spread over [0, N_VIRT)."""

    def __init__(self, seed=0, dense=2 * FUSED_SHARDS * 8,
                 sparse=SPARSE_SHARDS * 8):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.sizes = {f"d{i}": 30 + 4 * (i % FUSED_SHARDS)
                      for i in range(dense)}
        self.ids = {f"s{i}": np.sort(rng.choice(N_VIRT, 40, replace=False))
                    for i in range(sparse)}
        self.graphs = {}
        for name, n in self.sizes.items():
            lo, hi = self._pairs(n, 3 * n)
            self.graphs[name] = EdgeList.from_arrays(
                lo, hi, rng.uniform(0.5, 1.5, lo.size), n_nodes=n)
        for name, ids in self.ids.items():
            lo, hi = self._pairs(ids.size, 80)
            mask = np.zeros(N_VIRT, np.float32)
            mask[ids] = 1.0
            self.graphs[name] = EdgeList.from_arrays(
                ids[lo], ids[hi], rng.uniform(0.5, 1.5, lo.size),
                n_nodes=N_VIRT, node_mask=torch.from_numpy(mask))

    def _pairs(self, n, m):
        a = self.rng.integers(0, n, m)
        b = (a + 1 + self.rng.integers(0, n - 1, m)) % n
        keys = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
        return keys // n, keys % n

    def admit(self, fleet):
        for name, g in self.graphs.items():
            fleet.admit(name, g)

    def tick(self):
        """One tick's tenant-space deltas (added weight on distinct
        lanes), fresh host tensors every call."""
        out = {}
        for name, n in self.sizes.items():
            lo, hi = self._pairs(n, K)
            out[name] = GraphDelta.from_arrays(
                lo, hi, self.rng.uniform(0.1, 0.5, lo.size),
                np.zeros(lo.size), n_nodes=n, k_pad=K, j_pad=J)
        for name, ids in self.ids.items():
            lo, hi = self._pairs(ids.size, K)
            out[name] = GraphDelta.from_arrays(
                ids[lo], ids[hi], self.rng.uniform(0.1, 0.5, lo.size),
                np.zeros(lo.size), n_nodes=N_VIRT, k_pad=K, j_pad=J)
        return out


def _bits(fleet):
    torch.cuda.synchronize()
    out = {(p, s, k): v.cpu().numpy().copy()
           for p, s in fleet.live_shard_ids()
           for k, v in fleet.shard_service(p, s).states().tensors().items()}
    out["scores"] = fleet.scores()
    return out


def _assert_bits(a, b, label):
    assert a.keys() == b.keys(), label
    assert a["scores"] == b["scores"], label
    for k in a:
        if k != "scores":
            np.testing.assert_array_equal(a[k], b[k], f"{label}: {k}")


def _assert_close_to_cpu(card, cpu, label):
    got, want = card["scores"], cpu["scores"]
    for n in want:
        g, w = float(got[n]), float(want[n])
        np.testing.assert_allclose(g * g, w * w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{label}: {n}")
        if w * w > 1e-3:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{label}: {n}")
    assert card.keys() == cpu.keys(), label
    for k in cpu:
        if k == "scores":
            continue
        if k[2] == "node_mask":
            np.testing.assert_array_equal(card[k], cpu[k], str(k))
        else:
            np.testing.assert_allclose(card[k], cpu[k], atol=1e-5,
                                       rtol=1e-5, err_msg=str(k))


def test_stacked_fleet_is_bit_equal_to_shard_by_shard(cuda):
    """One launch of each stacked kernel a tick against one launch a
    shard, bit-equal at every tick, before and after a compaction
    splits the fused pool into three layout groups; the stacked fleet
    within tolerance of the same fleet on the CPU."""
    runs = {}
    for key, dev, stacked in (("stacked", cuda, True),
                              ("sequential", cuda, False),
                              ("cpu", "cpu", True)):
        tenants = Tenants(seed=1)
        fleet = FingerFleet.open(_config(stacked, compact_occupancy=0.99),
                                 device=dev)
        tenants.admit(fleet)
        runs[key] = (fleet, tenants)
    for t in range(6):
        bits = {}
        for key, (fleet, tenants) in runs.items():
            before = (dict(st_ops.LAUNCHES), dict(sp_ops.LAUNCHES))
            fleet.ingest(tenants.tick())
            if t == 3:
                actions = fleet.rebalance()
                assert len(actions) == FUSED_SHARDS
            fleet.poll()
            groups = FUSED_SHARDS if t >= 3 else 1
            if key == "stacked":
                assert fleet.last_poll_launches == groups + 1
                assert st_ops.LAUNCHES["stream_tick_stacked"] == \
                    before[0]["stream_tick_stacked"] + groups
                assert sp_ops.LAUNCHES["sparse_tick_stacked"] == \
                    before[1]["sparse_tick_stacked"] + 1
            if key == "sequential":
                assert fleet.last_poll_launches == \
                    FUSED_SHARDS + SPARSE_SHARDS
                assert st_ops.LAUNCHES["stream_tick"] == \
                    before[0]["stream_tick"] + FUSED_SHARDS
                assert sp_ops.LAUNCHES["sparse_tick"] == \
                    before[1]["sparse_tick"] + SPARSE_SHARDS
            bits[key] = _bits(fleet)
        _assert_bits(bits["stacked"], bits["sequential"], f"tick {t}")
        _assert_close_to_cpu(bits["stacked"], bits["cpu"], f"tick {t}")
    tops = [f.top_anomalies(4) for f, _ in runs.values()]
    assert tops[0] == tops[1]
    for fleet, _ in runs.values():
        fleet.close()


PROFILE_SCRIPT = """
import json, sys, torch
sys.path.insert(0, sys.argv[2])
from torch.profiler import ProfilerActivity, profile
from test_torch_cuda_fleet import Tenants, _config
from repro_torch.fleet import FingerFleet
fleet = FingerFleet.open(_config(True))
tenants = Tenants(seed=2)
tenants.admit(fleet)
ticks = [tenants.tick() for _ in range(6)]
for d in ticks[:3]:
    fleet.ingest(d)
    fleet.poll()
fleet.scores()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for d in ticks[3:]:
        fleet.ingest(d)
        fleet.poll()
    torch.cuda.synchronize()
p.export_chrome_trace(sys.argv[1])
events = json.load(open(sys.argv[1]))["traceEvents"]
names = [e["name"] for e in events if e.get("ph") == "X"
         and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
print(json.dumps(names))
"""


def test_one_stacked_kernel_per_layout_group_per_poll(cuda, tmp_path):
    """torch.profiler, in a process of its own (a second profiler run in
    one process records no device events): 3 fleet ticks of one fused and
    one sparse layout group run exactly 3 launches of the stream tick
    and 3 of the sparse tick — one each a poll, whatever the number of
    shards."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(dispatch.REPO_ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", PROFILE_SCRIPT, str(tmp_path / "trace.json"),
         here], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    ticks = [n for n in names if "tick_kernel" in n]
    assert sum("tick_kernel<false" in n for n in ticks) == 3, ticks
    assert sum("tick_kernel<true" in n for n in ticks) == 3, ticks
    assert len(ticks) == 6, ticks


def test_stack_waits_for_the_side_stream_copies(cuda):
    """The compute stream is held back by a sleep kernel while the
    fleet ingests (each shard's delta copied into its pinned slot and
    onto the card on the side stream) and polls (the stack queued behind
    the sleep); right after `ingest` the router's host staging buffers
    are overwritten with NaN. The scores and state still equal those of
    the same fleet ticked without either."""
    fleets = {}
    for key in ("held", "plain"):
        tenants = Tenants(seed=3)
        fleet = FingerFleet.open(_config(True), device=cuda)
        tenants.admit(fleet)
        fleets[key] = (fleet, tenants)
    for t in range(4):
        plain, tp = fleets["plain"]
        plain.ingest(tp.tick())
        plain.poll()
        held, th = fleets["held"]
        torch.cuda._sleep(100_000_000)  # holds the compute stream back
        held.ingest(th.tick())
        stages = held.router._stages
        assert len(stages) == FUSED_SHARDS
        for stage in stages.values():
            for buf in stage._buffers().values():
                buf.fill(-1 if buf.dtype == np.int32 else np.nan)
        held.poll()
        _assert_bits(_bits(held), _bits(plain), f"tick {t}")
    for fleet, _ in fleets.values():
        fleet.close()


def test_residency_fallback_ticks_shard_by_shard(cuda, monkeypatch):
    """A budget below every group's stacked operands sends both pools
    shard by shard: one single-shard launch a shard, no stacked launch,
    bit-equal to the stacked fleet."""
    budget = st_ops.fused_tick_stacked_bytes(1, B, N_PAD, K, J)
    assert budget < sp_ops.sparse_tick_stacked_bytes(1, SP_B, SLOTS, M_PAD,
                                                     K, J)
    fleets = {}
    for key in ("stacked", "fallback"):
        tenants = Tenants(seed=4)
        fleet = FingerFleet.open(_config(True), device=cuda)
        tenants.admit(fleet)
        fleets[key] = (fleet, tenants)
    for t in range(3):
        bits = {}
        for key, (fleet, tenants) in fleets.items():
            d = tenants.tick()
            if key == "fallback":
                monkeypatch.setattr(dispatch, "_BASE_STACKED_BUDGET_BYTES",
                                    budget - 1)
            before = (dict(st_ops.LAUNCHES), dict(sp_ops.LAUNCHES))
            fleet.ingest(d)
            fleet.poll()
            after = (dict(st_ops.LAUNCHES), dict(sp_ops.LAUNCHES))
            monkeypatch.undo()
            if key == "fallback":
                assert fleet.last_poll_launches == \
                    FUSED_SHARDS + SPARSE_SHARDS
                assert after[0]["stream_tick"] - before[0]["stream_tick"] \
                    == FUSED_SHARDS
                assert after[1]["sparse_tick"] - before[1]["sparse_tick"] \
                    == SPARSE_SHARDS
                assert after[0]["stream_tick_stacked"] == \
                    before[0]["stream_tick_stacked"]
                assert after[1]["sparse_tick_stacked"] == \
                    before[1]["sparse_tick_stacked"]
            bits[key] = _bits(fleet)
        _assert_bits(bits["fallback"], bits["stacked"], f"tick {t}")
    for fleet, _ in fleets.values():
        fleet.close()


def test_no_device_sync_in_ingest_and_poll(cuda):
    """Once every pinned slot has been used, a fleet tick's `ingest` and
    `poll` (the stacking, both kernels, the score plane left on the
    card) pass `no_transfers` (no host materialization, and
    `set_sync_debug_mode("error")`)."""
    tenants = Tenants(seed=5)
    fleet = FingerFleet.open(_config(True), device=cuda)
    tenants.admit(fleet)
    ticks = [tenants.tick() for _ in range(8)]
    for d in ticks[:4]:
        fleet.ingest(d)
        fleet.poll()
    torch.cuda.synchronize()
    before = dict(st_ops.LAUNCHES)
    with no_transfers(cuda, "fleet ingest + poll"):
        for d in ticks[4:]:
            fleet.ingest(d)
            fleet.poll()
    assert st_ops.LAUNCHES["stream_tick_stacked"] == \
        before["stream_tick_stacked"] + 4
    assert all(np.isfinite(v) for v in fleet.scores().values())
    fleet.close()
