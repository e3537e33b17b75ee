"""The paper-script twins (`benchmarks_torch/`) against the reference
scripts' own output, on the CPU.

Each reference script under `benchmarks/` is imported and run as it is:
its size constants (`fig1_degree.N`, `TRIALS`; `table3_dos.N`,
`INSTANCES`) and its imported `time_fn` are monkeypatched (the timing
columns are not compared), and its CSV rows are captured with `capsys`.
The twin runs on CPU tensors at the same settings, and the two are
compared row by row: the same row names in the same order, detections
and rates exactly (`detected_transition`, `correct`, `rate`, the trend
row), and AE, SAE, PCC, SRCC and peak/median within `TOL`.

fig2 (n = 200, 400, 800), fig4 (n = 200) and table2 (n = 300) run at
their own hard-coded sizes (each pair of runs takes under 10 s here);
fig1 runs at N = 120, TRIALS = 2 and table3 at N = 100, INSTANCES = 2.

Power iteration: the reference starts from a threefry draw and the port
from a seeded `torch.Generator` (ROADMAP Queue 3), and at
``power_iters=50`` the iteration has not converged on every graph
(fig4's FINGER peak/median is 6.88 from the port's own start against
5.47). So every twin here gets the reference's start vector through its
``start`` argument (the same vector the reference draws, seed 0), as
the parity tests pass ``x0=``. With it, every compared value agreed to
the last printed digit when this test was written; `TOL` is two units
of the 4th decimal that AE, SAE, PCC and SRCC are printed with (one of
the 2nd for peak/median).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # `benchmarks` and `benchmarks_torch`
    sys.path.insert(0, str(ROOT))

from benchmarks import fig1_degree as ref_fig1  # noqa: E402
from benchmarks import fig2_size as ref_fig2  # noqa: E402
from benchmarks import fig4_bifurcation as ref_fig4  # noqa: E402
from benchmarks import table2_wiki as ref_table2  # noqa: E402
from benchmarks import table3_dos as ref_table3  # noqa: E402
from benchmarks_torch import (common, fig1_degree, fig2_size,  # noqa: E402
                              fig4_bifurcation, run as twin_run,
                              table2_wiki, table3_dos)

TOL = 2e-4
TOL_CONTRAST = 0.02


def threefry_start(n: int) -> np.ndarray:
    """The reference power iteration's start vector (seed 0)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        jnp.float32))


def parse(text: str) -> list:
    """CSV rows → [(name, {key: value})]; a derived column without
    ``=`` (``reference``, a trend) is kept under ``""``."""
    rows = []
    for line in text.strip().splitlines():
        name, _, derived = line.split(",", 2)
        fields = {}
        for part in derived.split(";"):
            key, eq, value = part.partition("=")
            if eq:
                fields[key] = value
            else:
                fields[""] = part
        rows.append((name, fields))
    return rows


def number(value: str) -> float:
    return float(value.rstrip("%"))


def compare(ref_text: str, twin_text: str, close: dict, exact=()) -> None:
    """Row names in order; ``close`` keys within their tolerance;
    ``exact`` keys (and bare derived columns) equal."""
    ref, twin = parse(ref_text), parse(twin_text)
    assert [r[0] for r in twin] == [r[0] for r in ref]
    for (name, want), (_, got) in zip(ref, twin):
        assert set(got) == set(want), name
        for key, value in want.items():
            if key in close:
                assert abs(number(got[key]) - number(value)) <= close[key], \
                    (name, key, got[key], value)
            elif key in exact or key == "":
                assert got[key] == value, (name, key)


def reference_rows(module, capsys, monkeypatch, **constants) -> str:
    for key, value in constants.items():
        monkeypatch.setattr(module, key, value)
    if hasattr(module, "time_fn"):
        monkeypatch.setattr(module, "time_fn", lambda *a, **k: 1.0)
    capsys.readouterr()
    module.run()
    return capsys.readouterr().out


def twin_rows(fn, capsys, **kw) -> str:
    capsys.readouterr()
    rows = fn(device="cpu", start=threefry_start, **kw)
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == [line.split(",")[0]
                                    for line in out.strip().splitlines()]
    return out


def test_fig1_matches_the_reference(capsys, monkeypatch):
    ref = reference_rows(ref_fig1, capsys, monkeypatch, N=120, TRIALS=2)
    twin = twin_rows(fig1_degree.run, capsys, n=120, trials=2)
    compare(ref, twin, close={"AE": TOL})
    assert len(parse(twin)) == 27
    for _, fields in parse(twin):  # the time columns are numbers
        assert "CTRR" not in fields or np.isfinite(number(fields["CTRR"]))


def test_fig2_matches_the_reference_at_its_own_size(capsys, monkeypatch):
    ref = reference_rows(ref_fig2, capsys, monkeypatch)
    twin = twin_rows(fig2_size.run, capsys)
    compare(ref, twin, close={"SAE": TOL})
    trends = {name: f[""] for name, f in parse(twin) if "trend" in name}
    assert trends == {"fig2/ER/trend": "decays", "fig2/BA/trend": "grows",
                      "fig2/WS/trend": "decays"}


def test_fig4_matches_the_reference_at_its_own_size(capsys, monkeypatch):
    ref = reference_rows(ref_fig4, capsys, monkeypatch)
    twin = twin_rows(fig4_bifurcation.run, capsys)
    compare(ref, twin, close={"peak_over_median": TOL_CONTRAST},
            exact=("detected_transition", "planted", "correct"))
    got = dict(parse(twin))
    assert got["fig4/FINGER-JS(Fast)"]["correct"] == "True"
    assert got["fig4/VEO"]["correct"] == "False"


def test_table2_matches_the_reference_at_its_own_size(capsys, monkeypatch):
    ref = reference_rows(ref_table2, capsys, monkeypatch)
    twin = twin_rows(table2_wiki.run, capsys)
    compare(ref, twin, close={"PCC": TOL, "SRCC": TOL})
    assert len(parse(twin)) == 13
    assert parse(twin)[-1][0] == "table2/FINGER-JS(Inc)"


def test_table3_matches_the_reference(capsys, monkeypatch):
    ref = reference_rows(ref_table3, capsys, monkeypatch, N=100,
                         INSTANCES=2)
    twin = twin_rows(table3_dos.run, capsys, n=100, instances=2)
    compare(ref, twin, close={}, exact=("rate",))
    assert len(parse(twin)) == 4 * 7
    assert not hasattr(table3_dos, "_X")  # X is an argument in the twin


def test_time_fn_takes_the_median_and_emit_keeps_the_row(capsys):
    calls = []
    assert common.time_fn(lambda: calls.append(1), warmup=2, iters=3) >= 0
    assert len(calls) == 5
    common.emit("fig9/x", 1.5e-6, "AE=0.1")
    assert capsys.readouterr().out == "fig9/x,1.5,AE=0.1\n"


def test_run_harness_exit_status_and_only(capsys, monkeypatch):
    seen = []
    monkeypatch.setattr(twin_run, "SUITES", {
        "good": lambda device: seen.append(("good", device)),
        "bad": lambda device: 1 / 0,
    })
    twin_run.main(["--only", "good", "--device", "cpu"])
    assert seen == [("good", "cpu")]
    assert capsys.readouterr().out == "name,us_per_call,derived\n"
    with pytest.raises(SystemExit) as exc:
        twin_run.main(["--device", "cpu"])
    assert exc.value.code == 1
    assert "FAILED suites: ['bad']" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        twin_run.main(["--only", "kernels", "--device", "cpu"])
    assert exc.value.code == 2


def test_run_harness_names_the_reference_paper_suites():
    text = (ROOT / "benchmarks" / "run.py").read_text()
    assert sorted(twin_run.SUITES) == ["analysis", "fig1", "fig2", "fig4",
                                       "table2", "table3"]
    for name in twin_run.SUITES:  # each under the reference's own name
        assert f'"{name}": ' in text
