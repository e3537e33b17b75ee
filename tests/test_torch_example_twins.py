"""The example twins (`examples_torch/`) against the reference examples'
own output, on the CPU.

Each reference example under `examples/` is imported and run as it is
(`sys.argv` set to the flags of the case) and its standard output
captured with `capsys`; the twin runs on CPU tensors with the same
flags. The printed lines are compared one by one: the same text, every
number within `TOL` (ids, ticks, counts and the DETECTED/MISSED,
HIT/miss and PARITY OK words exactly), and the host times and the
checkpoint directory left out (`normalize`).

- `quickstart` and `anomaly_detection` at their own sizes; the twins get
  the reference's threefry start vector for FINGER-Ĥ's power iteration
  through ``start`` (the Hi-C FINGER peak/median is 6.88 from the
  port's own start against 5.47: 50 iterations have not converged).
- `serve_streams` under ``--placement local`` at 8 streams × 32 nodes ×
  4 ticks for each method, with ``--mixed-n --ckpt-dir``, with
  ``--compact-every``, sparse with mixed sizes, and ``--fleet --ticks
  6``. The twin's ``sharded`` and ``multipod`` runs are held bit for bit
  to its own local run (the reference's sharded placements are red
  here, ROADMAP Queue 3).
- `serve_batched` at its defaults, given the reference's parameters
  and prompts (threefry draws): the ``reqN:`` lines equal, token for
  token; and the serve launcher `repro_torch.launch.serve` prints the
  reference launcher's line. Neither launcher runs FINGER telemetry:
  the reference's docstring says that `launch/serve.py` does, but its
  `serve_batch` only decodes, and the port does the same.
- `train_with_entropy_probe` has a file of its own,
  `test_torch_train_example_twin.py` (the reference's compile alone
  takes about 18 s here).

`TOL` is 2e-4, two units of the 4th decimal the scores are printed
with; every compared number agreed to the last digit when this test was
written.
"""
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # `examples` and `examples_torch`
    sys.path.insert(0, str(ROOT))

from examples import anomaly_detection as ref_anomaly  # noqa: E402
from examples import quickstart as ref_quickstart  # noqa: E402
from examples import serve_batched as ref_batched  # noqa: E402
from examples import serve_streams as ref_serve  # noqa: E402
from examples_torch import anomaly_detection, quickstart, \
    serve_batched, serve_streams  # noqa: E402

TOL = 2e-4
NUMBER = re.compile(r"-?\d+\.\d+|-?\d+")
TIMING = (re.compile(r" in \d+\.\d+s \(\d+ stream-ticks/s"),
          re.compile(r"\d+\.\d+ms"), re.compile(r"checkpointed to \S+;"))
# the fleet demo's gap to its own oracle service, in each package
GAP = re.compile(r"\|Δ\|max = (\S+)")


def threefry_start(n: int) -> np.ndarray:
    """The reference power iteration's start vector (seed 0)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        jnp.float32))


def normalize(line: str) -> str:
    for pattern in TIMING:
        line = pattern.sub("<t>", line)
    return GAP.sub("|Δ|max = <gap>", line)


def compare_lines(ref_out: str, twin_out: str, tol: float = TOL) -> None:
    ref = [normalize(s) for s in ref_out.strip().splitlines()]
    twin = [normalize(s) for s in twin_out.strip().splitlines()]
    assert len(twin) == len(ref), (twin, ref)
    for want, got in zip(ref, twin):
        # a quickstart bar is int(400·JSdist) characters: its length
        # within one, the JSdist itself as a number
        assert abs(want.count("#") - got.count("#")) <= 1, (got, want)
        want_t, got_t = want.replace("#", ""), got.replace("#", "")
        assert NUMBER.sub("<n>", got_t).rstrip() == \
            NUMBER.sub("<n>", want_t).rstrip(), (got, want)
        for w, g in zip(NUMBER.findall(want_t), NUMBER.findall(got_t)):
            if "." in w:
                assert abs(float(g) - float(w)) <= tol, (got, want)
            else:
                assert g == w, (got, want)


def reference_out(capsys, monkeypatch, module, argv=()) -> str:
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def test_quickstart_matches_the_reference(capsys, monkeypatch):
    ref = reference_out(capsys, monkeypatch, ref_quickstart)
    scores = quickstart.main("cpu", start=threefry_start)
    twin = capsys.readouterr().out
    compare_lines(ref, twin)
    assert len(scores) == 10 and int(np.argmax(scores)) == 6


def test_anomaly_detection_matches_the_reference(capsys, monkeypatch):
    ref = reference_out(capsys, monkeypatch, ref_anomaly)
    detected = anomaly_detection.main("cpu", start=threefry_start)
    twin = capsys.readouterr().out
    compare_lines(ref, twin)
    assert detected["hic", "FINGER-JS"] == 5


SERVE = ("--streams", "8", "--nodes", "32", "--ticks", "4")


@pytest.mark.parametrize("flags", [
    ("--method", "dense"),
    ("--method", "compact"),
    ("--method", "fused_tick"),
    ("--method", "sparse_tick"),
    ("--method", "fused_tick", "--mixed-n", "--ckpt-dir", "CKPT",
     "--ticks", "6", "--ingestion", "sync"),
    ("--method", "dense", "--compact-every", "2", "--ticks", "6"),
    ("--method", "sparse_tick", "--mixed-n", "--nodes", "4096",
     "--active-nodes", "24", "--dos-frac", "0.5"),
], ids=["dense", "compact", "fused_tick", "sparse_tick", "ckpt",
        "compact_every", "sparse_mixed"])
def test_serve_streams_local_matches_the_reference(capsys, monkeypatch,
                                                   tmp_path, flags):
    def argv(who):
        return [*SERVE, *(str(tmp_path / who) if f == "CKPT" else f
                          for f in flags)]

    ref = reference_out(capsys, monkeypatch, ref_serve, argv("ref"))
    got = serve_streams.main([*argv("twin"), "--device", "cpu"])
    compare_lines(ref, capsys.readouterr().out)
    assert got["hit"] == ref.strip().endswith("DETECTED")


def test_serve_streams_detects_the_planted_dos_at_the_default_size(capsys):
    got = serve_streams.main(["--device", "cpu", "--ticks", "12"])
    assert got["hit"] and got["flagged"] == got["attack"][::-1]
    assert capsys.readouterr().out.strip().endswith("DETECTED")


@pytest.mark.parametrize("method", ["fused_tick", "sparse_tick"])
def test_serve_streams_placements_equal_the_local_run(capsys, method):
    runs = {p: serve_streams.main([*SERVE, "--method", method,
                                   "--placement", p, "--device", "cpu"])
            for p in ("local", "sharded", "multipod")}
    out = capsys.readouterr().out
    assert out.count("placement=sharded") == 1
    for p in ("sharded", "multipod"):
        np.testing.assert_array_equal(runs[p]["scores"],
                                      runs["local"]["scores"])
        assert runs[p]["top"] == runs["local"]["top"]
        assert runs[p]["flagged"] == runs["local"]["flagged"]


def test_serve_streams_fleet_matches_the_reference(capsys, monkeypatch):
    ref = reference_out(capsys, monkeypatch, ref_serve,
                        ["--fleet", "--ticks", "6"])
    got = serve_streams.main(["--fleet", "--ticks", "6", "--device", "cpu"])
    twin = capsys.readouterr().out
    compare_lines(ref, twin, tol=1e-5)
    assert got["ok"] and twin.strip().endswith("PARITY OK")
    assert ref.strip().endswith("PARITY OK")
    gaps = [float(g) for g in GAP.findall(twin)]
    assert len(gaps) == len(GAP.findall(ref)) > 0
    assert max(gaps) < 1e-5


def test_serve_batched_matches_the_reference(capsys, monkeypatch):
    from repro.configs.base import get_config
    from repro.distributed.sharding import NO_SHARDING
    from repro.models.api import model_param_defs
    from repro.models.params import init_params
    from repro_torch.interop import params_from_numpy

    ref = reference_out(capsys, monkeypatch, ref_batched)
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = init_params(model_param_defs(cfg, NO_SHARDING),
                         jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                 cfg.vocab_size)
    import torch

    seqs = serve_batched.main(
        ["--device", "cpu"],
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 "cpu"),
        prompts=torch.from_numpy(np.array(prompts)))
    twin = capsys.readouterr().out
    want = [s for s in ref.splitlines() if s.strip().startswith("req")]
    got = [s for s in twin.splitlines() if s.strip().startswith("req")]
    assert len(want) == 4 and got == want
    head = re.compile(r"decoded 4 requests x 32 tokens in \d+\.\d+s "
                      r"\(\d+ tok/s incl\. compile\)")
    assert head.fullmatch(ref.splitlines()[0])
    assert head.fullmatch(twin.splitlines()[0])
    assert len(twin.splitlines()) == len(ref.splitlines()) == 5
    assert tuple(seqs.shape) == (4, 32)


def test_serve_launcher_prints_the_reference_line(capsys, monkeypatch):
    from repro.launch import serve as ref_launch
    from repro_torch.launch import serve

    flags = ["--reduced", "--batch", "2", "--prompt-len", "4",
             "--max-new", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    capsys.readouterr()
    ref_launch.main()
    ref = capsys.readouterr().out.strip().splitlines()
    seqs = serve.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    line = re.compile(r"decoded \(2, 8\) in \d+\.\d+s \(\d+\.\d tok/s\); "
                      r"sample: \[(\d+, ){7}\d+\]")
    # one line each: no telemetry in either launcher
    assert len(ref) == len(got) == 1
    assert line.fullmatch(ref[0]) and line.fullmatch(got[0])
    assert got[0].endswith(f"sample: {seqs[0].tolist()}")
