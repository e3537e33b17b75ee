"""Shared-memory and register check of the kernels' launch configurations.

The port's counterpart of `repro.analysis.vmem`. The reference derives
each Pallas kernel's per-grid-step VMEM demand from its BlockSpecs; on
the card the question is whether each launch fits an SM and how it sits
there. Every ``csrc/*.cu`` computes the launch it makes (the
instantiation, grid, block and dynamic shared memory) in one helper a
kernel family, and exports it with CUDA's attributes of the
instantiation through ``<library>_launch_attrs``, read by
`kernels.dispatch.launch_attrs`: the launcher and the report share the
helper, so they cannot drift.

`collect_launch_configs` evaluates every instantiation the launchers can
choose at the shapes of the kernel packages' ``parity.py`` cases, of
the paths in ``chip_smoke.py`` and of the serving tests:

- ``tick_kernel<false|true, 0|2|4|8>`` (``stream_tick`` / ``sparse_tick``):
  phase 3 (B 32768, k 128, j 8), phase 5 (1024 streams, k 128), phase
  8's stacked groups, the parity and stress cases (those the stream
  tick splits at one warp a stream too, as phase 2 and the card tests
  force it), the sentinel's k = 3;
- ``tick_kernel<false, 0|2|4|8, true>``, the stream tick split over
  2, 4 or 8 warps a stream (``SPLIT_SHAPES``), at the warps
  `stream_tick.ops.warps_per_stream` gives on the card: the benchmark's
  512 long rows and the parity and stress cases;
- ``delta_stats_kernel<0|2|4|8>`` at k = 1 … 8192 and the sorted-form
  kernel at k = 9000;
- ``vnge_q_kernel<true|false>`` at n = 40, 1000 and 8192;
- ``bsr_matvec_kernel<128|64>`` at the parity cases and phase 7's n;
- ``row_stats_kernel<1|2|4|8, float4 or not>`` and
  ``graph_stats_kernel<true|false>`` at (192, 128), (48, 1000),
  (192, 1024) and ragged rows.

The rules (`check_launch_configs`, pure Python over the records, so the
CPU tests feed it a table):

- ``smem-over-limit`` — static plus dynamic shared memory above the
  card's per-block opt-in limit for a shape the Python guards admit;
- ``no-residency`` — an admitted launch that puts no block on an SM;
- ``guard-drift`` — the Python guards (`dispatch.smem_fits`,
  `stream_tick.ops.fits_fused_tick_stacked`,
  `sparse_tick.ops.fits_sparse_tick_stacked`,
  `delta_stats.ops.max_fused_k`) disagree with what the kernel's own
  prepare accepts, at the largest admitted shape and the next one up,
  or admit a launch the kernel refuses (the counterpart of the
  reference's ``vmem-estimate-undercounts``);
- ``no-launch`` — a kernel package whose parity case on the card left
  its ``LAUNCHES`` at 0 (the counterpart of ``vmem-no-launch``), and
  ``parity-mismatch`` where that case disagrees with the plain version.

Registers, spill bytes (``local_bytes``) and blocks an SM are reported
for every instantiation but are not violations. The parity launches are
comparisons: the wrappers' counts are put back after them.

It reads the card: on the CPU `collect_launch_configs` and `run_smem`
raise `SmemNeedsCard`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.kernels import dispatch

# (label, rows, k, j) of the tick launches the paths and cases make
TICK_SHAPES = {
    "stream_tick": (
        ("phase 3 B=32768", 32768, 128, 8),
        ("phase 8 stacked small 4x2048", 8192, 128, 8),
        ("phase 8 stacked large 2x2048", 4096, 128, 8),
        ("phase 2 stacked 3x2048", 6144, 128, 8),
        ("parity ragged k=37", 1000, 37, 3),
        ("stress k=200", 64, 200, 4),
        ("stress k=1024", 32, 1024, 8),
        ("sentinel k=3", 4, 3, 2),
    ),
    "sparse_tick": (
        ("phase 5 B=1024", 1024, 128, 8),
        ("phase 8 stacked virtual 2x512", 1024, 128, 8),
        ("phase 2 B=4096", 4096, 128, 8),
        ("parity ragged k=37", 1000, 37, 3),
        ("stress k=200", 64, 200, 4),
        ("stress k=1024", 32, 1024, 8),
        ("sentinel k=3", 4, 3, 2),
    ),
}
# (label, rows, n, k, j) of the stream tick launches the rule splits on
# an H100 (W 8, 2, 2, 8, 4 and 4)
SPLIT_SHAPES = (
    ("amazon-copurchase B=512", 512, 262144, 8, 4),
    ("parity ragged k=37", 1000, 333, 37, 3),
    ("stress k=37", 64, 333, 37, 3),
    ("stress serving k=128", 256, 1024, 128, 8),
    ("stress k=200", 64, 808, 200, 4),
    ("stress k=1024", 32, 4104, 1024, 8),
)
# (label, rows, k): the one-launch route up to max_fused_k, then sorted
DELTA_SHAPES = (("k=1", 1, 1), ("k=7", 1, 7), ("k=32", 1, 32),
                ("k=64", 1, 64), ("k=128 B=1024", 1024, 128),
                ("k=129", 1, 129), ("k=1000 2x37", 74, 1000),
                ("k=8192", 1, 8192), ("k=9000 sorted", 1, 9000))
VNGE_NS = (40, 1000, 8192)
# (label, n, b) → n_rb = ceil(n / b) stripes
BSR_SHAPES = (("phase 7 n=2^18", 1 << 18, 128), ("ragged n=300", 300, 128),
              ("n=1000 b=64", 1000, 64), ("n=32768", 32768, 128))
# (BH, S): the training probe, the parity shapes, and ragged rows that
# reach every row-stats instantiation with and without float4 loads
PROBE_SHAPES = ((192, 128), (48, 1000), (192, 1024), (48, 127), (48, 250),
                (48, 256), (48, 500), (48, 510), (48, 999))


class SmemNeedsCard(RuntimeError):
    """`smem` asked for without a CUDA card: it reads the card."""


@dataclasses.dataclass
class LaunchConfig:
    """One launch of one kernel instantiation at one shape."""
    package: str
    kernel: str
    shape: str
    grid: int
    block: int
    dyn_smem: int
    static_smem: int
    registers: int
    local_bytes: int
    max_threads: int
    blocks_per_sm: int
    smem_limit: int
    accepted: bool   # the launcher's own checks and prepare take it
    admitted: bool   # the Python guards would launch it

    @property
    def smem(self) -> int:
        return self.static_smem + self.dyn_smem

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), smem=self.smem)


@dataclasses.dataclass
class GuardCheck:
    """One Python guard against the kernel's prepare at one shape."""
    guard: str
    shape: str
    guard_admits: bool
    kernel_accepts: bool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SmemViolation:
    rule: str
    kernel: str
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SmemReport:
    device: str
    configs: List[LaunchConfig]
    guards: List[GuardCheck]
    parity_launches: Dict[str, int]
    violations: List[SmemViolation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "device": self.device,
                "configs": [c.to_dict() for c in self.configs],
                "guards": [g.to_dict() for g in self.guards],
                "parity_launches": dict(self.parity_launches),
                "violations": [v.to_dict() for v in self.violations]}


def _card(device: dispatch.Device) -> torch.device:
    dev = dispatch.resolve_device(device)
    if dev.type != "cuda":
        raise SmemNeedsCard(
            "smem reads CUDA's attributes of the kernels' instantiations "
            "on the card (cudaFuncGetAttributes and the occupancy "
            "calculator); it has no CPU form — run it on a machine with a "
            "CUDA card (--device cuda)")
    return dev


def _config(package: str, which: int, shape: str, admitted: bool,
            a: int, b: int = 0, c: int = 0) -> LaunchConfig:
    rec = dispatch.launch_attrs(package, which, a, b, c)
    return LaunchConfig(
        package=package, kernel=str(rec["kernel"]), shape=shape,
        admitted=admitted, **{k: rec[k] for k in dispatch.LAUNCH_ATTRS})


def collect_launch_configs(device: dispatch.Device = None
                           ) -> List[LaunchConfig]:
    """Every instantiation at the shapes listed in the module docstring,
    on the card of ``device``."""
    dev = _card(device)
    from repro_torch.kernels.delta_stats.ops import max_fused_k
    from repro_torch.kernels.stream_tick import ops as st_ops

    out: List[LaunchConfig] = []
    with torch.cuda.device(dev):
        for name, shapes in TICK_SHAPES.items():
            for label, rows, k, j in shapes:
                out.append(_config(name, 0, label,
                                   dispatch.smem_fits(name, k, j, dev),
                                   rows, k, j))
        for label, rows, n, k, j in SPLIT_SHAPES:
            warps = st_ops.warps_per_stream(
                rows, n, *st_ops._capacity(torch.cuda.current_device(), k, j))
            out.append(_config("stream_tick", warps, f"{label} W={warps}",
                               dispatch.smem_fits("stream_tick", k, j, dev),
                               rows, k, j))
        k_max = max_fused_k()
        for label, rows, k in DELTA_SHAPES:
            one = k <= k_max
            out.append(_config("delta_stats", 0 if one else 1, label, True,
                               rows, k if one else 2 * k))
        for n in VNGE_NS:
            out.append(_config("vnge_q", 0, f"n={n}", True, n))
        for label, n, b in BSR_SHAPES:
            out.append(_config("bsr_spmv", 0, label, True, -(-n // b), b))
        for bh, s in PROBE_SHAPES:
            vec = int(s % 4 == 0)
            for which in (0, 1):
                out.append(_config("entropy_probe", which,
                                   f"BH={bh} S={s}", True, bh * s
                                   if which == 0 else bh, s, vec))
    return out


def _largest(admits: Callable[[int], bool], hi: int = 1 << 16) -> int:
    """The largest k in [0, hi] that ``admits`` (monotone: admits k ⇒
    admits every smaller k)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if admits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def collect_guards(device: dispatch.Device = None) -> List[GuardCheck]:
    """Each Python guard against the kernel's prepare at the largest k it
    admits and at the next one up."""
    dev = _card(device)
    from repro_torch.kernels.delta_stats.ops import max_fused_k
    from repro_torch.kernels.sparse_tick.ops import fits_sparse_tick_stacked
    from repro_torch.kernels.stream_tick.ops import fits_fused_tick_stacked

    j = 8
    guards: Dict[str, Tuple[str, Callable[[int], bool]]] = {
        "dispatch.smem_fits('stream_tick')": (
            "stream_tick", lambda k: dispatch.smem_fits("stream_tick", k, j,
                                                        dev)),
        "stream_tick.ops.fits_fused_tick_stacked": (
            "stream_tick", lambda k: fits_fused_tick_stacked(
                2, 8, 64, k, j, device=dev)),
        "dispatch.smem_fits('sparse_tick')": (
            "sparse_tick", lambda k: dispatch.smem_fits("sparse_tick", k, j,
                                                        dev)),
        "sparse_tick.ops.fits_sparse_tick_stacked": (
            "sparse_tick", lambda k: fits_sparse_tick_stacked(
                2, 8, 64, 64, k, j, device=dev)),
        "delta_stats.ops.max_fused_k": (
            "delta_stats", lambda k: k <= max_fused_k()),
    }
    out: List[GuardCheck] = []
    with torch.cuda.device(dev):
        for guard, (package, admits) in guards.items():
            k_max = _largest(admits)
            for k in (k_max, k_max + 1):
                rec = dispatch.launch_attrs(package, 0, 1, k, j)
                out.append(GuardCheck(guard, f"k={k}", admits(k),
                                      bool(rec["accepted"])))
    return out


# -- the parity cases of each kernel package on the card ------------------
def _parity_stream_tick(dev, seed):
    from repro_torch.kernels.stream_tick import ops, parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    states, deltas = parity.make_case(64, 333, 37, 3, seed=seed, device=dev)
    parity.compare(ops.stream_tick_fused(states, deltas),
                   stream_tick_ref(states, deltas), "smem stream_tick")


def _parity_sparse_tick(dev, seed):
    from repro_torch.kernels.sparse_tick import ops, parity

    case = parity.make_case(64, 333, 777, 37, 3, seed=seed, device=dev)
    parity.check(lambda s, d, e: ops.sparse_tick_fused(s, d, exact_smax=e),
                 case, True, "smem sparse_tick")


def _parity_delta_stats(dev, seed):
    from repro_torch.core.incremental import gate_delta_for_update
    from repro_torch.kernels.delta_stats import ops, parity

    state, delta = parity.make_case(512, 128, seed=seed, device=dev)
    gated, _ = gate_delta_for_update(state.node_mask, delta)
    parity.compare(ops.delta_stats_cuda(state.strengths, gated),
                   parity.plain(state.strengths, gated), "smem delta_stats")


def _parity_vnge_q(dev, seed):
    from repro_torch.kernels.vnge_q import ops, parity
    from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

    w, mask = parity.make_case(1000, seed=seed, device=dev, masked=True)
    parity.compare(ops.vnge_q_stats(w, node_mask=mask),
                   vnge_q_stats_ref(ops._apply_node_mask(w, mask)),
                   "smem vnge_q")


def _parity_entropy_probe(dev, seed):
    from repro_torch.kernels.entropy_probe import ops, parity, ref

    x = parity.make_case(48, 1000, seed=seed, device=dev)
    rows = ops.row_stats_cuda(x)
    parity.compare(rows, ref.row_stats_ref(x), "smem row_stats")
    parity.compare([ops.graph_stats_cuda(x, *rows)],
                   [ref.graph_stats_ref(x, *rows)], "smem graph_stats")


def _parity_bsr_spmv(dev, seed):
    from repro_torch.kernels.bsr_spmv import ops, parity
    from repro_torch.kernels.bsr_spmv.ref import bsr_matvec_ref

    m, x = parity.make_case(300, 128, seed=seed, device=dev)
    parity.compare(ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x),
                   bsr_matvec_ref(m, x), "smem bsr_matvec")


PARITY_RUNS: Dict[str, Callable] = {
    "stream_tick": _parity_stream_tick, "sparse_tick": _parity_sparse_tick,
    "delta_stats": _parity_delta_stats, "vnge_q": _parity_vnge_q,
    "entropy_probe": _parity_entropy_probe, "bsr_spmv": _parity_bsr_spmv}


def run_parity(device: dispatch.Device = None, seed: int = 0
               ) -> Tuple[Dict[str, int], List[SmemViolation]]:
    """Each kernel package's parity case on the card: its launches by
    package, and a ``parity-mismatch`` for a case that disagrees with
    its plain version. The wrappers' counts are put back after."""
    from repro_torch.analysis.sanitize import (launch_counts,
                                               set_launch_counts)
    from repro_torch.kernels.parity import discover_kernel_packages

    dev = _card(device)
    launches: Dict[str, int] = {}
    mismatches: List[SmemViolation] = []
    saved = launch_counts()
    try:
        for name in discover_kernel_packages():
            before = sum(launch_counts().values())
            run = PARITY_RUNS.get(name)
            if run is not None:
                try:
                    with torch.cuda.device(dev):
                        run(dev, seed)
                        torch.cuda.synchronize(dev)
                except AssertionError as exc:
                    mismatches.append(SmemViolation(
                        "parity-mismatch", name, str(exc).splitlines()[0]))
            launches[name] = sum(launch_counts().values()) - before
    finally:
        set_launch_counts(saved)
    return launches, mismatches


def check_launch_configs(configs: List[LaunchConfig],
                         guards: List[GuardCheck],
                         parity_launches: Dict[str, int]
                         ) -> List[SmemViolation]:
    """The rules of the module docstring over collected (or given)
    records."""
    out: List[SmemViolation] = []
    for c in configs:
        where = f"{c.package} {c.kernel} at {c.shape}"
        if not c.admitted:
            continue
        if c.smem > c.smem_limit:
            out.append(SmemViolation(
                "smem-over-limit", c.kernel,
                f"{where}: {c.static_smem} B static + {c.dyn_smem} B "
                f"dynamic shared memory a block, above the card's "
                f"{c.smem_limit} B, for a shape the Python guards admit"))
        if not c.accepted:
            out.append(SmemViolation(
                "guard-drift", c.kernel,
                f"{where}: the Python guards admit the launch but the "
                "kernel's own prepare refuses it"))
        elif c.blocks_per_sm == 0:
            out.append(SmemViolation(
                "no-residency", c.kernel,
                f"{where}: 0 blocks an SM at {c.block} threads, "
                f"{c.registers} registers a thread and {c.smem} B of "
                "shared memory"))
    for g in guards:
        if g.guard_admits != g.kernel_accepts:
            out.append(SmemViolation(
                "guard-drift", g.guard,
                f"{g.guard} {'admits' if g.guard_admits else 'refuses'} "
                f"{g.shape} but the kernel's prepare "
                f"{'accepts' if g.kernel_accepts else 'refuses'} it — the "
                "guard has drifted from the kernel it guards"))
    for name, n in sorted(parity_launches.items()):
        if n == 0:
            out.append(SmemViolation(
                "no-launch", name,
                f"kernel package '{name}' launched no kernel during its "
                "parity case on the card — its launch is not exercised, "
                "so its configuration cannot be checked"))
    return out


def run_smem(device: dispatch.Device = None,
             seed: int = 0) -> SmemReport:
    """Collect every launch configuration and guard, run the parity
    cases, and check them."""
    dev = _card(device)
    configs = collect_launch_configs(dev)
    guards = collect_guards(dev)
    parity_launches, violations = run_parity(dev, seed)
    violations = check_launch_configs(configs, guards,
                                      parity_launches) + violations
    return SmemReport(device=torch.cuda.get_device_name(dev),
                      configs=configs, guards=guards,
                      parity_launches=parity_launches,
                      violations=violations)


def table(report: SmemReport) -> List[str]:
    """The report's launch configurations as aligned text rows."""
    rows = [f"{'package':13} {'instantiation':28} {'shape':30} "
            f"{'regs':>4} {'spill':>5} {'smem':>7} {'blk/SM':>6}"]
    for c in report.configs:
        rows.append(f"{c.package:13} {c.kernel:28} {c.shape:30} "
                    f"{c.registers:>4} {c.local_bytes:>5} {c.smem:>7} "
                    f"{c.blocks_per_sm:>6}")
    return rows
