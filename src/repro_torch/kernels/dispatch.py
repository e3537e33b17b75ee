"""Kernel dispatch for the port: device resolution and the CUDA library.

The counterpart of `repro.kernels.dispatch`, rewritten for one NVIDIA
Hopper card instead of a TPU:

- ``resolve_device`` is the one home of the port's device policy. Entry
  points run on ``cuda`` unless the caller asks for the CPU; asking for
  ``cuda`` on a machine without a card raises, it never carries on
  quietly on the CPU.
- ``library()`` builds the hand-written kernels under
  ``src/repro_torch/csrc/*.cu`` at first use — one ``nvcc`` process per
  source file, all started together, each into a shared object with a
  plain C interface — and loads them with ``ctypes``. The build goes to
  ``build/repro_torch/<hash>/`` at the repository root, keyed by a hash
  of the sources and flags, so an edited ``.cu`` rebuilds and an
  unchanged one is reused. ``REPRO_TORCH_BUILD_DIR`` moves the build
  root.
- There is no fallback. A failed build raises `KernelBuildError` with
  the compiler's own text, and a launch that CUDA refuses raises
  `KernelLaunchError` with CUDA's error string (``check_launch``).

The kernel wrappers take their plain PyTorch version only for tensors
that lie on the CPU, which is how the CPU tests run; for a CUDA tensor
they launch the kernel or raise.

Shard-stacked launches (the fleet's pool tick) add an admission guard,
the counterpart of the reference's: ``stacked_residency_bytes_ok``
holds the whole S-stacked operand set of one launch against
``stacked_budget_bytes()`` (256 MB unless ``REPRO_STACKED_BUDGET_BYTES``
says otherwise, read once at import, as the reference reads it), and
``smem_fits`` is the per-block shared-memory fit the reference checks
as a per-grid-step VMEM fit, answered without raising. A group that
fails either ticks shard by shard.

``launch_attrs`` reads a library's ``<name>_launch_attrs`` export: the
launch its launcher makes for given shapes (instantiation, grid, block,
dynamic shared memory, from the helper the launcher itself calls) with
CUDA's attributes of that instantiation (registers, spills, static
shared memory, blocks an SM). `repro_torch.analysis.smem` checks them.

``FIRST_USE`` counts the first-use costs a warmed serving path must not
pay: a kernel library load here (``library_load``) and a cold
`serving.plans.build_plan` (``build_plan``), each bumped through
`note_first_use`; `repro_torch.analysis.sanitize.first_use_budget`
reads them.

Build flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` plus
``--fmad=false``. The scores are the square root of a difference of
entropies that is about 0 on an unchanged stream, so contracting
``a*b + c`` into an FMA moves them most of all; without contraction the
kernels round like the unfused elementwise ops of the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler",
              "-fPIC")

Device = Union[str, torch.device, None]


FIRST_USE = {"library_load": 0, "build_plan": 0}
_FIRST_USE_LOCK = threading.Lock()


def note_first_use(kind: str) -> None:
    """Count one first-use event of ``kind`` (a key of ``FIRST_USE``)."""
    with _FIRST_USE_LOCK:
        FIRST_USE[kind] += 1


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """CUDA refused or failed a kernel launch."""


def resolve_device(device: Device = None) -> torch.device:
    """``None`` → ``cuda``; a ``cuda`` device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; the port "
                         "runs on 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
        "kernels of repro_torch are built from source at first use")


def build_dir() -> Path:
    """Where the libraries of the current sources live."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build" / "repro_torch"))
    return root / h.hexdigest()[:16]


class _Library:
    """The loaded kernel libraries, one ``ctypes.CDLL`` per source."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds = 0.0
        self._lock = threading.Lock()

    def load(self) -> Dict[str, ctypes.CDLL]:
        with self._lock:
            if not self.libs:
                t0 = time.perf_counter()
                self.libs = _build_and_load()
                self.build_seconds = time.perf_counter() - t0
                note_first_use("library_load")
        return self.libs


def _build_and_load() -> Dict[str, ctypes.CDLL]:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        so = out / f"lib{src.stem}.so"
        if so.is_file():
            continue
        tmp = out / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so, cmd)
    errors = []
    for stem, (proc, tmp, so, cmd) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, so)
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return {src.stem: ctypes.CDLL(str(out / f"lib{src.stem}.so"))
            for src in sources}


_LIBRARY = _Library()


def library() -> Dict[str, ctypes.CDLL]:
    """Build (first call) and return the kernel libraries by source stem."""
    return _LIBRARY.load()


def build_seconds() -> float:
    """Seconds the first `library()` call spent building and loading."""
    return _LIBRARY.build_seconds


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple,
         restype=ctypes.c_int):
    """``symbol`` of the kernel library ``name`` with its ctypes
    signature set once per process (the libraries load once), so a
    wrapper does not set it on every call."""
    fn = getattr(library()[name], symbol)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def empty_launch(name: str, device: torch.device) -> None:
    """Launch an empty kernel through library ``name``'s ctypes path on
    the current stream: the floor of a one-launch op. It counts in no
    wrapper's ``LAUNCHES``."""
    err = bind(name, "repro_empty_launch", (ctypes.c_void_p,))(
        stream_handle(device))
    check_launch(name, err)


def check_launch(name: str, err: int) -> None:
    """Raise with CUDA's own text when a launch returned an error code."""
    if err != 0:
        fn = library()[name].repro_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        text = fn(int(err))
        raise KernelLaunchError(
            f"{name} launch failed with CUDA error {err}: "
            f"{text.decode() if text else 'unknown'}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a Python int.

    Read raw, as PyTorch's own generated code reads it: building the
    `torch.cuda.Stream` object that `torch.cuda.current_stream` returns
    costs about as much host time as a kernel launch.
    """
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


LAUNCH_ATTRS = ("grid", "block", "dyn_smem", "static_smem", "registers",
                "local_bytes", "max_threads", "blocks_per_sm", "smem_limit",
                "accepted")


def launch_attrs(name: str, which: int, a: int, b: int = 0,
                 c: int = 0) -> Dict[str, object]:
    """The launch kernel library ``name``'s launcher ``which`` makes for
    the shape arguments (a, b, c) and CUDA's attributes of the
    instantiation it picks, as the ``<name>_launch_attrs`` export
    reports them (`launch_attributes` in ``csrc/common.cuh``): the
    keys of ``LAUNCH_ATTRS`` plus ``kernel``, the instantiation's
    name. ``accepted`` says whether the launcher would launch it (its
    own range checks and the shared-memory opt-in); ``blocks_per_sm``
    is 0 where it would not."""
    fn = bind(name, f"{name}_launch_attrs",
              (ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p,
               ctypes.c_int))
    out = (ctypes.c_longlong * len(LAUNCH_ATTRS))()
    buf = ctypes.create_string_buffer(64)
    check_launch(name, fn(int(which), int(a), int(b), int(c),
                          ctypes.cast(out, ctypes.c_void_p), buf,
                          len(buf)))
    rec: Dict[str, object] = dict(zip(LAUNCH_ATTRS, (int(v) for v in out)))
    rec["accepted"] = bool(rec["accepted"])
    rec["kernel"] = buf.value.decode()
    return rec


def smem_bytes(name: str, k: int, j: int) -> int:
    """Dynamic shared memory one block of the tick kernel ``name`` needs
    for k edge lanes and j node slots, as the kernel's own layout
    (`TickLayout`) computes it."""
    fn = getattr(library()[name], f"{name}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(k, j))


def smem_limit(name: str, device: torch.device) -> int:
    """The card's shared memory per block, with the opt-in above 48 KB,
    as the tick kernel ``name``'s library reads it."""
    fn = getattr(library()[name], f"{name}_smem_limit")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    limit = int(fn(device.index if device.index is not None
                   else torch.cuda.current_device()))
    if limit < 0:
        raise KernelLaunchError(
            f"{name}: could not read the card's shared memory limit")
    return limit


def residency(name: str, k: int, j: int) -> Dict[str, int]:
    """How the tick kernel ``name`` sits on the card for k edge lanes and
    j node slots: resident blocks per SM (CUDA's occupancy calculator),
    streams per block, streams per SM and registers per thread."""
    fn = getattr(library()[name], f"{name}_residency")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    check_launch(name, fn(k, j, ctypes.cast(out, ctypes.c_void_p)))
    blocks, streams, regs = out
    return {"blocks_per_sm": blocks, "streams_per_block": streams,
            "streams_per_sm": blocks * streams, "registers": regs}


def check_smem(name: str, k: int, j: int, device: torch.device) -> None:
    """Refuse by name a (k_pad, j_pad) whose shared-memory layout is
    above the card's per-block limit."""
    need, limit = smem_bytes(name, k, j), smem_limit(name, device)
    if need > limit:
        raise ValueError(
            f"{name}: k_pad={k}, j_pad={j} need {need} bytes of shared "
            f"memory per block, above the card's {limit}")


def smem_fits(name: str, k: int, j: int, device: Device = None) -> bool:
    """Whether a block of the tick kernel ``name`` fits the card's
    shared memory for k edge lanes and j node slots (`check_smem`
    without the raise). On the CPU the plain version runs, which has no
    such limit."""
    device = resolve_device(device)
    if device.type != "cuda":
        return True
    return smem_bytes(name, k, j) <= smem_limit(name, device)


DEFAULT_STACKED_BUDGET_BYTES = 256 * 1024 * 1024

_env = os.environ.get("REPRO_STACKED_BUDGET_BYTES")
_BASE_STACKED_BUDGET_BYTES = int(_env) if _env \
    else DEFAULT_STACKED_BUDGET_BYTES
del _env


def stacked_budget_bytes() -> int:
    """Device-residency budget of one shard-stacked launch's operands
    (see the module docstring)."""
    return _BASE_STACKED_BUDGET_BYTES


def stacked_residency_bytes_ok(total_bytes: int) -> bool:
    """Whether a stacked launch's operands fit the stacked budget; a
    group that does not ticks shard by shard."""
    return int(total_bytes) <= stacked_budget_bytes()


def check_operands(name: str, device: torch.device, operands) -> None:
    """Raise by name unless every ``(label, tensor, shape, dtype)`` lies
    on ``device``, contiguous, with that shape and dtype."""
    for label, t, shape, dtype in operands:
        if tuple(t.shape) != tuple(shape) or t.device != device:
            raise ValueError(
                f"{name}: {label} tensor has shape {tuple(t.shape)} on "
                f"{t.device}, expected {tuple(shape)} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} tensor is not contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} tensor must be {dtype}, got "
                            f"{t.dtype}")
