"""One run of a cell: set-up, the measured window, the traced ticks, and
the comparison with the reference that decides ``correct``.

The system under test is `repro_torch.serving.FingerService` as its
configuration file states it (``fused_tick`` or ``sparse_tick``,
``local``, ``double_buffered``, exact s_max, ``max_queue`` 2; a
``sparse_tick`` configuration's set-up and read-back are
`bench.virtual`'s). The loop is closed with work dispatched ahead, as a
producer that hands in each window of changes while the last one is
scored:

    ingest(tick i)        # the copy of tick i's delta overlaps tick i-1
    scores(); top_anomalies(k)   # tick i-1's results on the host
    poll()                # launches tick i

Every stream is scored on every tick and the top-k read on every tick;
under ``sparse_tick`` ``ingest`` takes the tick's B per-stream virtual
deltas. A tick's latency runs from the call of ``ingest`` with its delta
to the return of its ``top_anomalies``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import compare, graphs, roofline, traffic, virtual
from bench import trace as trace_mod
from bench.reference import edges, finger
from bench.spec import Cell
from repro_torch.core.state import FingerState
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving import FingerService, ServiceConfig
from repro_torch.serving.config import TopKSpec
from repro_torch.serving.plans import build_plan

REF_STREAMS = 32        # streams the reference follows, drawn from the seed
SCALAR_STREAMS = 65_536  # streams whose Q, S and s_max it checks, likewise,
SCALAR_EDGES = 1 << 31   # and at most as many as hold this many edges
JUDGE_EVERY = 64        # one tick in this many keeps its whole scores
TRACED_TICKS = 64       # ticks under the profiler in a traced run
BLOCK_EDGES = 60_000_000  # edges drawn at once while setting up
WINDOW_SPAN = "bench.traced"
SPANS = ("ingest", "readback", "poll")


@dataclasses.dataclass
class Inputs:
    """What set-up makes from the seed: the initial stacked state on the
    device and one cycle of stacked host deltas (each field
    (period, B, ·), pageable)."""

    states: FingerState
    host: Dict[str, torch.Tensor]
    deltas: List[GraphDelta]

    def bytes_needed(self, tick: int) -> int:
        """The bytes the delta of cycle tick ``tick`` needs moved."""
        h = {f: v[tick].numpy() for f, v in self.host.items()}
        return roofline.bytes_needed(
            h["senders"], h["receivers"], h["dw"], h["mask"], h["node_ids"],
            h["node_flag"], self.deltas[0].n_nodes)


@dataclasses.dataclass
class Record:
    """What the metric readers read (`bench/metrics/*.py`)."""

    batch: int
    window: tuple           # (start, end) on the host clock, seconds
    setup_s: float
    t_in: np.ndarray        # per tick: ingest called
    t_done: np.ndarray      # per tick: results on the host (nan: never)
    spans: Dict[str, List[float]]  # seconds a call, window ticks only
    trace: Optional[trace_mod.Trace] = None

    def mean_span_ms(self, name: str) -> Optional[float]:
        """Mean ms a call of the span ``name``; None without spans."""
        spans = self.spans.get(name)
        return 1e3 * sum(spans) / len(spans) if spans else None


def service_config(cfg: dict) -> ServiceConfig:
    svc = dict(cfg["service"])
    k = svc.pop("topk_k")
    return ServiceConfig(topk=TopKSpec(k), **svc)


def make_inputs(cfg: dict, mix: dict, seed: int,
                device: torch.device) -> Inputs:
    """The initial state of every stream's seed-defined graph, built on
    the device in blocks, and the cycle of deltas (under sparse_tick,
    `virtual.make_inputs`' graphs and deltas)."""
    if virtual.is_sparse(cfg):
        return virtual.make_inputs(
            cfg, mix, seed, device,
            max(1, BLOCK_EDGES // int(cfg["graph"]["edges"])))
    svc, graph = cfg["service"], cfg["graph"]
    b, n_pad = svc["batch_size"], svc["n_pad"]
    k_pad, j_pad = svc["k_pad"], svc["j_pad"]
    traffic.check(mix, n_pad, k_pad, j_pad, graph)
    period = traffic.period(mix)
    f32, f64 = torch.float32, torch.float64
    strengths = torch.empty(b, n_pad, dtype=f32, device=device)
    node_mask = torch.empty(b, n_pad, dtype=f32, device=device)
    q, s_total, s_max = (torch.empty(b, dtype=f32, device=device)
                         for _ in range(3))
    host = {f: torch.empty((period, b, j_pad if f.startswith("node")
                            else k_pad), dtype=traffic.host_dtype(f))
            for f in traffic.FIELDS}
    slots = torch.arange(n_pad, device=device)
    block = max(1, BLOCK_EDGES // int(graph["edges"]))
    for b0 in range(0, b, block):
        b1 = min(b, b0 + block)
        streams = torch.arange(b0, b1, dtype=torch.int64, device=device)
        keys, offsets, w = graphs.edges(graph, seed, streams)
        row, lo, hi = graphs.split_keys(keys)
        s = torch.zeros((b1 - b0) * n_pad, dtype=f64, device=device)
        s.index_add_(0, row * n_pad + lo, w)
        s.index_add_(0, row * n_pad + hi, w)
        s = s.view(b1 - b0, n_pad)
        sum_w2 = torch.zeros(b1 - b0, dtype=f64, device=device)
        sum_w2.index_add_(0, row, w * w)
        total = s.sum(1)
        c = 1.0 / total
        q[b0:b1] = 1.0 - c * c * ((s * s).sum(1) + 2.0 * sum_w2)
        s_total[b0:b1] = total
        s_max[b0:b1] = s.amax(1)
        strengths[b0:b1] = s
        live = graphs.n_live(graph, seed, streams)
        node_mask[b0:b1] = (slots[None, :] < live[:, None]).to(f32)
        del s, row, lo, hi
        d = traffic.block_deltas(mix, graph, seed, streams, keys, offsets,
                                 w, k_pad, j_pad)
        for f in traffic.FIELDS:
            host[f][:, b0:b1] = d[f].to(traffic.host_dtype(f)).cpu()
        del keys, offsets, w, d
    states = FingerState(q=q, s_total=s_total, s_max=s_max,
                         strengths=strengths, node_mask=node_mask,
                         layout=NodeLayout(n_pad))
    deltas = [GraphDelta(n_nodes=n_pad,
                         **{f: host[f][t] for f in traffic.FIELDS})
              for t in range(period)]
    return Inputs(states, host, deltas)


class Loop:
    """The serving loop over one service, with what the comparison and
    the readers need kept on the side."""

    def __init__(self, svc: FingerService, inputs: Inputs, k: int,
                 sample: np.ndarray, judge_phase: int,
                 scalar_sample: np.ndarray):
        self.svc, self.inputs, self.k = svc, inputs, k
        self.period = len(inputs.deltas)
        self.sample = sample
        self.scalar_sample = scalar_sample
        self.judge_phase = judge_phase
        self.ticks = 0          # ticks handed in
        self.read = 0           # ticks whose results are on the host
        self.t_in: List[float] = []
        self.t_done: List[float] = []
        self.scores = np.empty((1024, len(sample)), np.float32)
        self.judged: list = []
        self.nonfinite = 0
        self.spans: Optional[Dict[str, List[float]]] = None
        self._read = None       # the results of the tick last read
        self.annotate = False

    def _span(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(f"bench.{name}")
        return contextlib.nullcontext()

    def _ingest(self) -> None:
        t = time.perf_counter()
        self.t_in.append(t)
        with self._span("ingest"):
            self.svc.ingest(self.inputs.deltas[self.ticks % self.period])
        self.ticks += 1
        if self.spans is not None:
            self.spans["ingest"].append(time.perf_counter() - t)

    def _poll(self) -> None:
        t = time.perf_counter()
        with self._span("poll"):
            self.svc.poll()
        if self.spans is not None:
            self.spans["poll"].append(time.perf_counter() - t)

    def _readback(self) -> None:
        t = time.perf_counter()
        with self._span("readback"):
            scores = self.svc.scores()
            vals, ids = self.svc.top_anomalies(self.k)
        done = time.perf_counter()
        self.t_done.append(done)
        if self.spans is not None:
            self.spans["readback"].append(done - t)
        self._read = (scores, vals, ids)

    def _keep(self) -> None:
        """What the comparison and `failed` need of the tick last read,
        kept while the next tick runs on the device."""
        scores, vals, ids = self._read
        self._read = None
        i = self.read
        if i == len(self.scores):
            self.scores = np.concatenate([self.scores,
                                          np.empty_like(self.scores)])
        self.scores[i] = scores[self.sample]
        finite = np.isfinite(scores)
        if not finite.all():
            self.nonfinite += int((~finite).sum())
        if i % JUDGE_EVERY == self.judge_phase:
            self.judged.append((scores, vals, ids))
        self.read += 1

    def start(self) -> None:
        """Hand in and launch one tick with none in flight."""
        self._ingest()
        self._poll()

    def step(self) -> None:
        """Hand in the next tick, read the one in flight, launch the
        next, then keep what was read."""
        self._ingest()
        self._readback()
        self._poll()
        self._keep()

    def drain(self) -> None:
        """Read the tick in flight."""
        if self.read < self.ticks:
            self._readback()
            self._keep()

    def align(self, phase: int) -> None:
        """Tick one at a time until the ticks applied are ``phase``
        modulo the period, every result read."""
        self.drain()
        while self.ticks % self.period != phase:
            self.start()
            self.drain()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scalar_streams(cfg: dict) -> int:
    """How many streams' Q, S and s_max the comparison checks: all of
    them, at most `SCALAR_STREAMS`, and at most as many as hold
    `SCALAR_EDGES` edges, so that the reference's pass over their graphs
    stays within a few seconds."""
    edges = int(cfg["graph"]["edges"])
    return min(SCALAR_STREAMS, cfg["service"]["batch_size"],
               max(1, SCALAR_EDGES // edges))


def traced_ticks(cfg: dict, window_ticks: int) -> int:
    """The ticks a traced run profiles: `TRACED_TICKS`, at most as many
    as the window held, and under sparse_tick at most
    `virtual.TRACED_STREAM_TICKS` stream-ticks or
    `virtual.TRACED_MIN_TICKS` ticks, whichever is more (each stream's
    translation puts about ninety host operations, 24 KB, into the
    trace)."""
    ticks = min(TRACED_TICKS, max(1, window_ticks))
    if virtual.is_sparse(cfg):
        b = cfg["service"]["batch_size"]
        ticks = min(ticks, max(virtual.TRACED_MIN_TICKS,
                               virtual.TRACED_STREAM_TICKS // b))
    return ticks


def _profile(loop: Loop, device: torch.device, ticks: int):
    """A bounded run of ``ticks`` steady ticks under `torch.profiler`,
    read back as a `trace.Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    loop.drain()
    _sync(device)
    first = loop.ticks
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            loop.annotate = True
            loop.start()
            for _ in range(ticks - 1):
                loop.step()
            loop.drain()
            _sync(device)
            loop.annotate = False
    period = loop.period
    per_tick = {t: loop.inputs.bytes_needed(t) for t in range(period)}
    needed = sum(per_tick[t % period] for t in range(first, first + ticks))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return trace_mod.load(path, WINDOW_SPAN, ticks, needed)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def serve(cell: Cell, seed: int, device: torch.device,
          exact_smax: Optional[bool] = None):
    """Set-up: the inputs, the service over them and its loop, warmed on
    the cell's own shapes through the loop itself. ``exact_smax`` runs
    the service against its configuration (a control)."""
    cfg = cell.config
    config = service_config(cfg)
    if exact_smax is not None:
        config = config.with_(exact_smax=exact_smax)
    inputs = make_inputs(cfg, cell.mix, seed, device)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    b = config.batch_size
    sample = np.sort(rng.choice(b, size=min(REF_STREAMS, b),
                                replace=False))
    sparse = virtual.is_sparse(cfg)
    if sparse:
        svc = FingerService.open(config, inputs.graphs(), device=device)
    else:
        svc = FingerService(config, build_plan(config, device),
                            inputs.states)
        inputs.states = None
    judge_phase = int(rng.integers(JUDGE_EVERY))
    scalar_sample = np.sort(rng.choice(b, size=scalar_streams(cfg),
                                       replace=False))
    loop = Loop(svc, inputs, config.topk.k, sample, judge_phase,
                scalar_sample)
    loop.start()
    for _ in range(virtual.WARM_STEPS if sparse else len(inputs.deltas) + 2):
        loop.step()
    if sparse:
        # a window may hold only a few sparse ticks: judge its first
        loop.judge_phase = loop.read % JUDGE_EVERY
    _sync(device)
    return inputs, svc, loop


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> dict:
    """One run of ``cell``; returns the result object (without the check
    for foreign modules, which the entry point makes)."""
    cfg = cell.config
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    inputs, svc, loop = serve(cell, seed, device)
    b = cfg["service"]["batch_size"]

    error = None
    spans = {s: [] for s in SPANS}
    t0 = time.perf_counter()
    first_tick = loop.ticks
    try:
        if trace:
            loop.spans = spans
        while time.perf_counter() - t0 < seconds:
            loop.step()
        loop.spans = None
        t1 = t0 + seconds
        window_ticks = np.array(loop.t_in[first_tick:])
        attempted = b * int(((window_ticks >= t0)
                             & (window_ticks <= t1)).sum())
        tr = _profile(loop, device, traced_ticks(
            cfg, loop.ticks - first_tick)) if trace else None
        loop.align(int(cell.mix["cycle_ticks"]))
        _sync(device)
    except Exception as e:  # a tick that raised fails the run
        error = f"{type(e).__name__}: {e}"
        t1 = t0 + seconds
        attempted = b * max(1, loop.ticks - first_tick)
        tr = None
    failed = loop.nonfinite + (b if error else 0)
    t_closed = time.perf_counter()

    t_done = np.full(len(loop.t_in), np.nan)
    t_done[:len(loop.t_done)] = loop.t_done
    rec = Record(b, (t0, t1), t0 - t_start, np.array(loop.t_in), t_done,
                 spans, tr)
    metrics = {}
    for m in cell.reported(trace):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)}
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": trace_mod.top_ops(tr),
                            "idle_gaps": trace_mod.labelled_gaps(tr)}
        limit = _power_limit() if device.type == "cuda" else None
        if limit:
            dev_info["name_and_power_limit"] = limit
    if error:
        out["error"] = error
        out["checks"] = {}
        return out

    # the comparison: the program's state is read, then freed, before
    # the reference runs
    outputs = Outputs.collect(svc, loop)
    svc.close()
    del svc, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, _ = program_numbers(cfg, seed, inputs.host, outputs, device)
    checks = compare.judge(numbers, cfg["limits"])
    out["correct"] = failed == 0 and compare.passed(checks)
    out["readings"] = {k: v for k, v in numbers.items() if k not in checks}
    out["reference_s"] = time.perf_counter() - t_closed
    out["checks"] = checks
    return out


@dataclasses.dataclass
class Outputs:
    """What the timed path produced, as the comparison reads it."""

    sample: np.ndarray      # the sampled streams
    ticks: np.ndarray       # global index of each read tick
    scores: np.ndarray      # (ticks, sampled streams)
    state: Dict[str, np.ndarray]    # sampled streams' state, each (S, ·)
    scalar_sample: np.ndarray       # the streams of ``scalars``
    scalars: Dict[str, np.ndarray]  # their q, s_total and s_max
    final_tick: int
    judged: list            # (scores, values, ids) of the judged ticks
    k: int
    maps: Optional[list] = None     # sparse: the sampled streams' SlotMaps

    @classmethod
    def collect(cls, svc: FingerService, loop: Loop) -> "Outputs":
        states = svc.states()
        sample = loop.sample
        idx = torch.as_tensor(sample, device=states.q.device)
        state = {f: t.index_select(0, idx).cpu().numpy()
                 for f, t in states.tensors().items()}
        at = torch.as_tensor(loop.scalar_sample, device=states.q.device)
        scalars = {f: getattr(states, f).index_select(0, at).double()
                   .cpu().numpy() for f in ("q", "s_total", "s_max")}
        maps = None if svc.slot_maps is None \
            else [svc.slot_maps[s] for s in sample]
        return cls(sample, np.arange(loop.read),
                   loop.scores[:loop.read].copy(), state,
                   loop.scalar_sample, scalars, loop.ticks,
                   list(loop.judged), loop.k, maps)


def program_numbers(cfg: dict, seed: int, host: Dict[str, torch.Tensor],
                    outputs: Outputs, device: torch.device):
    """The comparison's numbers of the program's outputs, and the
    reference of the sampled streams. A sparse_tick configuration's
    state is read back into dense ids first, and what its slot maps
    leave over is judged too (`virtual.read_back`)."""
    period = len(host["dw"])
    refs = reference_streams(cfg, seed, outputs.sample, host,
                             torch.float64, device)
    want = reference_scalars(cfg, seed, host, outputs.scalar_sample,
                             outputs.final_tick % period, device)
    state, left = outputs.state, None
    if outputs.maps is not None:
        state, left = virtual.read_back(state, outputs.maps,
                                        virtual.Relabel(cfg, seed))
    numbers = compare.gaps(outputs.ticks, outputs.scores, state,
                           refs, outputs.final_tick, period,
                           scalars=(outputs.scalars, want))
    numbers["topk_gap"] = compare.topk_gap(outputs.judged, outputs.k)
    if left is not None:
        numbers["mask_gap"] += left["stray_masks"]
        phase = outputs.final_tick % period
        for s, ref in zip(left["stray_strengths"], refs):
            numbers["state_gap"] = max(numbers["state_gap"], s / max(
                ref["states"](phase)["s_max"], 1e-30))
        numbers["edge_gap"] = compare.edge_gap(
            left["stores"], reference_edges(cfg, seed, outputs.sample, host,
                                            phase))
    return numbers, refs


def reference_scalars(cfg: dict, seed: int, host: Dict[str, torch.Tensor],
                      streams: np.ndarray, ticks: int, device: torch.device
                      ) -> Dict[str, np.ndarray]:
    """The Q, S and s_max of ``streams`` after ``ticks`` deltas of the
    cycle, from the reference, in blocks."""
    block = max(1, BLOCK_EDGES // int(cfg["graph"]["edges"]))
    parts = []
    for b0 in range(0, len(streams), block):
        ids = torch.as_tensor(streams[b0:b0 + block], dtype=torch.int64)
        got = finger.batch_scalars(cfg["graph"], seed, ids.to(device),
                                   {f: v[:, ids] for f, v in host.items()},
                                   virtual.id_space(cfg), ticks)
        parts.append({f: v.cpu().numpy() for f, v in got.items()})
    return {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}


def reference_streams(cfg: dict, seed: int, sample: np.ndarray,
                      host: Dict[str, torch.Tensor], dtype: torch.dtype,
                      device: torch.device) -> List[dict]:
    """The reference (or, in bfloat16, the control) of each sampled
    stream over the cycle of deltas."""
    n_pad = virtual.id_space(cfg)
    return [finger.cycle(cfg["graph"], seed, int(s),
                         {f: host[f][:, int(s)].numpy() for f in host},
                         n_pad, dtype=dtype, device=device)
            for s in sample]


def reference_edges(cfg: dict, seed: int, sample: np.ndarray,
                    host: Dict[str, torch.Tensor], ticks: int,
                    dtype: torch.dtype = torch.float64) -> List[dict]:
    """The reference's (or, in bfloat16, the control's) edge weights of
    each sampled stream after ``ticks`` deltas of the cycle."""
    return [edges.weights(cfg["graph"], seed, int(s),
                          {f: host[f][:, int(s)].numpy() for f in host},
                          virtual.id_space(cfg), ticks, dtype)
            for s in sample]


def control_numbers(cfg: dict, seed: int, host: Dict[str, torch.Tensor],
                    outputs: Outputs, refs: List[dict],
                    device: torch.device) -> Dict[str, float]:
    """The comparison's numbers of the control: the reference computed
    in bfloat16, put in the program's place for the same sampled
    streams, the same ticks and the same final state."""
    period = len(host["dw"])
    ctrl = reference_streams(cfg, seed, outputs.sample, host,
                             torch.bfloat16, device)
    scores = np.stack([c["scores"][outputs.ticks % period] for c in ctrl], 1)
    states = [c["states"](outputs.final_tick % period) for c in ctrl]
    state = {f: np.stack([np.asarray(s[f]) for s in states])
             for f in ("q", "s_total", "s_max", "strengths", "node_mask")}
    numbers = compare.gaps(outputs.ticks, scores, state, refs,
                           outputs.final_tick, period)
    numbers["topk_gap"] = 0.0
    if virtual.is_sparse(cfg):
        phase = outputs.final_tick % period
        ctrl_edges = reference_edges(cfg, seed, outputs.sample, host, phase,
                                     torch.bfloat16)
        numbers["edge_gap"] = compare.edge_gap(
            [(w, np.zeros(0)) for w in ctrl_edges],
            reference_edges(cfg, seed, outputs.sample, host, phase))
    return numbers


def foreign_modules(names) -> List[str]:
    """Loaded modules of JAX, Flax, the JAX package ``repro`` or the JAX
    package's ``benchmarks``, compared by whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    return sorted(n for n in names if n.split(".")[0] in banned)


def dumps(out: dict) -> str:
    """The result line, with the checks last."""
    checks = out.pop("checks", {})
    out["checks"] = checks
    return json.dumps(out)


def environment() -> None:
    """Keep the program's build inside the checkout."""
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(Path(__file__).resolve().parent.parent
                              / "build" / "repro_torch"))
