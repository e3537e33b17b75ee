"""The port's analysis gates on the CPU: lint, sanitizers, tick audit,
the smem rules and the sentinel chains.

Each rule is shown catching a seeded hazard by its name, and its pragma
or its clean case passing. The two lint rules shared with the reference
report the same lines as `repro.analysis.lint` on the same sources. The
migration chain's final scores are held to the JAX `FingerService`
driven over the reference's own `_graphs` and `_tick_deltas` at atol 1e-5
with rtol 1e-5, a score held as its divergence (score²) where that is
below 1e-3 (the serving tests' rule: the score is the square root of a
difference of float32 entropies). The reference's ``compile_budget`` and
its red ``test_fleet_chain_budgets`` are no oracle here. What needs the
card (`smem`, the audit's sync check, the allocator count) is in
`test_torch_cuda_analysis.py`.
"""
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

import repro.analysis.lint as jlint
import repro.analysis.sentinel as jsentinel
import repro.serving as jserving
from repro_torch.analysis import lint, sanitize, sentinel, smem, tick_audit
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import dispatch
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.serving.plans import build_plan

ROOT = Path(__file__).resolve().parents[1]
PORT = "src/repro_torch/x.py"
CPU = torch.device("cpu")


def rules(source, path=PORT):
    return [(v.rule, v.line, v.suppressed)
            for v in lint.lint_source(textwrap.dedent(source), path)]


# -- lint -----------------------------------------------------------------
HAZARDS = {
    "frozen-dataclass-mutable-default": """
        import dataclasses
        @dataclasses.dataclass(frozen=True)
        class C:
            xs: list = []
        """,
    "per-item-host-sync": """
        def f(ts):
            for t in ts:
                t.sum().item()
        """,
    "numpy-handoff-no-copy": """
        import numpy as np, torch
        def f():
            buf = np.zeros(4)
            t = torch.from_numpy(buf)
            buf[0] = 1.0
        """,
    "jax-import": """
        import jax.numpy as jnp
        """,
    "tf32-enabled": """
        import torch
        torch.backends.cuda.matmul.allow_tf32 = True
        """,
    "kernel-fallback": """
        from repro_torch.kernels.dispatch import KernelLaunchError
        def f(s, d):
            try:
                return stream_tick_fused(s, d)
            except KernelLaunchError:
                return None
        """,
}


@pytest.mark.parametrize("rule", sorted(HAZARDS))
def test_lint_rule_catches_its_hazard_and_its_pragma_suppresses(rule):
    source = textwrap.dedent(HAZARDS[rule])
    found = [(r, line) for r, line, s in rules(source) if not s]
    assert [r for r, _ in found] == [rule], found
    line = found[0][1]
    lines = source.split("\n")
    lines[line - 1] += f"  # lint: disable={rule}"
    got = rules("\n".join(lines))
    assert got == [(rule, line, True)]
    lines[line - 1] = lines[line - 1].replace(rule, "all")
    assert rules("\n".join(lines)) == [(rule, line, True)]


@pytest.mark.parametrize("expr", [
    "t.item()", "float(f(t))", "np.asarray(f(t))", "np.asarray(t.x)",
    "f(t).cpu()", "t[0].tolist()", "f(t).cpu().numpy()",
    "t.x.detach().cpu().numpy()"])
def test_per_item_host_sync_forms(expr):
    got = rules(f"""
        import numpy as np
        def g(ts):
            for t in ts:
                y = {expr}
        """)
    assert got == [("per-item-host-sync", 5, False)]


@pytest.mark.parametrize("expr", [
    "np.asarray(t)", "t.cpu()", "t.cpu().numpy()", "float(t)",
    "t.tolist()"])
def test_per_item_host_sync_exempts_named_pulls_and_outside_loops(expr):
    assert rules(f"""
        import numpy as np
        def g(ts, u):
            for t in ts:
                y = {expr}
            z = u.sum().item()
        """) == []


def test_port_rules_apply_only_to_the_port():
    src = "import jax\nimport repro.serving\nimport repro_torch.serving\n"
    assert [r[:2] for r in rules(src)] == [("jax-import", 1),
                                          ("jax-import", 2)]
    for path in ("chip_smoke.py", "benchmarks_torch/run.py",
                 "examples_torch/quickstart.py"):
        assert len(rules(src, path)) == 2
    assert rules(src, "tests/test_x.py") == []
    assert rules(src, "src/repro/x.py") == []


@pytest.mark.parametrize("source,want", [
    ("torch.set_float32_matmul_precision('high')\n", 1),
    ("torch.set_float32_matmul_precision('highest')\n", 0),
    ("torch.backends.cudnn.allow_tf32 = False\n", 0),
])
def test_tf32_rule_cases(source, want):
    assert len(rules("import torch\n" + source)) == want


def test_kernel_fallback_needs_a_kernel_call_and_no_raise():
    base = """
        def f(x):
            try:
                {call}
            except (ValueError, RuntimeError) as exc:
                {handler}
        """
    def run(call, handler):
        return rules(base.format(call=call, handler=handler))

    assert [r[0] for r in run("return vnge_q_stats(x)", "return 0")] == \
        ["kernel-fallback"]
    assert run("return vnge_q_stats(x)", "raise ValueError() from exc") \
        == []
    assert run("return float(x)", "return 0") == []
    assert [r[0] for r in run("return delta_stats_cuda(x, x)", "pass")] \
        == ["kernel-fallback"]


def test_numpy_handoff_as_tensor_and_rebind():
    src = """
        import numpy as np, torch
        def f():
            buf = np.zeros(4)
            t = torch.as_tensor(buf)
            buf += 1
        def g():
            buf = np.zeros(4)
            t = torch.from_numpy(buf)
            buf = np.ones(4)
            buf[0] = 2.0
        def h():
            buf = np.zeros(4)
            t = torch.from_numpy(buf.copy())
            buf[0] = 1.0
        """
    assert [r[:2] for r in rules(src)] == [("numpy-handoff-no-copy", 5)]


def test_kernel_package_triple(tmp_path):
    kernels, csrc = tmp_path / "kernels", tmp_path / "csrc"
    for d in (kernels / "good", kernels / "bad", csrc):
        d.mkdir(parents=True)
    (csrc / "good.cu").write_text("")
    for f in ("ops.py", "ref.py", "parity.py"):
        (kernels / "good" / f).write_text(
            'fn = dispatch.bind("good", "good_launch", ())\n'
            'lib = dispatch.library()["good"]\n' if f == "ops.py" else "")
    (kernels / "bad" / "ops.py").write_text(
        '\n\nfn = dispatch.bind("missing", "x_launch", ())\n')
    (kernels / "bad" / "ref.py").write_text("")
    got = lint.check_kernel_triples(kernels, csrc)
    assert [(v.rule, Path(v.path).parent.name, v.line) for v in got] == [
        ("kernel-package-triple", "bad", 1),
        ("kernel-package-triple", "bad", 3)]
    assert "parity.py" in got[0].message and "missing.cu" in got[1].message


SHARED = {
    "frozen-dataclass-mutable-default": """
        import dataclasses
        from dataclasses import dataclass, field
        @dataclasses.dataclass(frozen=True)
        class A:
            xs: list = []
            ys: dict = {}
            zs: tuple = ()
            ok: list = field(default_factory=list)
        @dataclass(frozen=True)
        class B:
            s: set = set()
            a: object = np.zeros(3)
        @dataclasses.dataclass
        class NotFrozen:
            xs: list = []
        """,
    "per-item-host-sync": """
        import numpy as np
        def f(xs, plane):
            for x in xs:
                a = x.item()
                b = float(g(x))
                c = np.asarray(x.attr)
                d = np.asarray(h(x)[0])
                e = np.asarray(plane)
                f_ = float(x)
            while xs:
                xs.pop().item()
            return [y.item() for y in xs]
        """,
}


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rules_report_the_reference_lines(rule):
    source = textwrap.dedent(SHARED[rule])
    want = sorted({v.line for v in jlint.lint_source(source, "x.py")
                   if v.rule == rule})
    got = sorted({v.line for v in lint.lint_source(source, PORT)
                  if v.rule == rule})
    assert got == want and len(got) >= 3


def test_port_tree_lints_clean():
    report = lint.lint_tree(ROOT)
    assert report.ok, [str(v) for v in report.unsuppressed]
    files = {Path(v.path).parts[0] for v in report.violations}
    assert {"chip_smoke.py", "src", "benchmarks_torch"} <= files
    assert len(lint.port_files(ROOT)) > 100


# -- sanitizers -----------------------------------------------------------
def test_transfer_budget_counts_and_raises_by_name():
    x = torch.arange(4.0)
    with sanitize.transfer_budget(None, "count") as c:
        x[1].item()
        float(x.sum())
        int(x[0])
        bool(x[2] > 0)
        x.tolist()  # a CPU tensor's tolist does not dispatch
    assert c.count == 4 and all("_local_scalar_dense" in op
                                for op in c.ops)
    with pytest.raises(sanitize.TransferBudgetExceeded,
                       match=r"\(scores\): 2 device→host .* budget 1"):
        with sanitize.transfer_budget(1, "scores"):
            float(x[0])
            float(x[1])
    with sanitize.transfer_budget(1, "one"):
        float(x[0])


def test_transfer_budgets_nest_and_restore_the_mode_stack():
    x = torch.arange(4.0)
    assert _get_current_dispatch_mode() is None
    with sanitize.transfer_budget(None) as outer:
        x[0].item()
        with sanitize.transfer_budget(None) as inner:
            x[1].item()
        x[2].item()
        with pytest.raises(sanitize.TransferBudgetExceeded):
            with sanitize.transfer_budget(0):
                x[3].item()
        assert _get_current_dispatch_mode() is not None
    assert (outer.count, inner.count) == (4, 1)
    assert _get_current_dispatch_mode() is None
    with pytest.raises(ZeroDivisionError):
        with sanitize.transfer_budget(None):
            1 / 0
    assert _get_current_dispatch_mode() is None


def test_no_transfers_refuses_by_op_name_and_restores():
    x = torch.arange(4.0)
    with pytest.raises(sanitize.TransferBudgetExceeded,
                       match=r"refused \(tick\): aten\._local_scalar_dense"):
        with sanitize.no_transfers(CPU, "tick"):
            y = x * 2
            y.sum().item()
    assert _get_current_dispatch_mode() is None
    with sanitize.no_transfers(CPU) as c:
        (x * 2).cumsum(0)
    assert c.count == 0


def test_sanitizers_on_cuda_without_a_card_fail_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cm in (sanitize.no_transfers(), sanitize.first_use_budget(0)):
        with pytest.raises(RuntimeError, match="is_available"):
            with cm:
                pass


def test_host_materialization_names_cuda_to_host_copies():
    class Fake:
        is_cuda = True

    cpu = torch.zeros(2)
    assert sanitize.host_materialization(
        torch.ops.aten._to_copy.default, (Fake(),), {"device": "cpu"}) \
        == "aten._to_copy of a CUDA tensor to the CPU"
    assert sanitize.host_materialization(
        torch.ops.aten.copy_.default, (cpu, Fake()), {}) \
        == "aten.copy_ of a CUDA tensor into a CPU tensor"
    assert sanitize.host_materialization(
        torch.ops.aten._to_copy.default, (cpu,), {"device": "cpu"}) is None
    assert sanitize.host_materialization(
        torch.ops.aten.copy_.default, (cpu, cpu), {}) is None


def test_first_use_budget_counts_cold_plans_and_library_loads(monkeypatch):
    from repro_torch.serving import ServiceConfig, TopKSpec

    cfg = ServiceConfig(batch_size=2, n_pad=8, k_pad=2, ingestion="sync",
                        topk=TopKSpec(k=1))
    with sanitize.first_use_budget(None, device=CPU) as c:
        build_plan(cfg, CPU)
    assert c.events == {"library_load": 0, "build_plan": 1,
                        "allocator_segment": 0} and c.count == 1
    with pytest.raises(sanitize.FirstUseBudgetExceeded,
                       match=r"\(migration\): 1 event\(s\) \(build_plan=1\)"):
        with sanitize.first_use_budget(0, "migration", device=CPU):
            build_plan(cfg, CPU)
    lib = dispatch._Library()
    monkeypatch.setattr(dispatch, "_build_and_load", lambda: {"x": 1})
    with sanitize.first_use_budget(None, device=CPU) as c:
        lib.load()
        lib.load()  # loaded once
    assert c.events["library_load"] == 1
    assert sanitize.assert_first_use_at_most(lambda: 7, 0,
                                             device=CPU) == 7
    with pytest.raises(sanitize.FirstUseBudgetExceeded):
        sanitize.assert_first_use_at_most(build_plan, 0, cfg, CPU,
                                          device=CPU)


def test_debug_nan_checks_names_the_op():
    with pytest.raises(sanitize.NanCheckError,
                       match=r"NaN produced by aten\.div\.Tensor"):
        with sanitize.debug_nan_checks():
            z = torch.zeros(3)
            z / z
    outside = torch.full((3,), float("nan"))
    with pytest.raises(sanitize.NanCheckError,
                       match=r"kernel launch before aten\.add\.Tensor"):
        with sanitize.debug_nan_checks():
            outside + 1
    with sanitize.debug_nan_checks():  # uninitialised memory is written
        e = torch.empty(1 << 16)
        e.fill_(1.0)
        torch.add(torch.ones(4), 1, out=torch.empty(4))
        assert float(e.sum()) == 1 << 16
    with sanitize.debug_nan_checks(enable=False):
        torch.zeros(1) / torch.zeros(1)
    assert _get_current_dispatch_mode() is None


def test_launch_counts_round_trip():
    saved = sanitize.launch_counts()
    assert {"stream_tick", "stream_tick_stacked", "sparse_tick",
            "delta_stats", "vnge_q", "row_stats", "graph_stats",
            "bsr_matvec"} <= set(saved)
    try:
        st_ops.LAUNCHES["stream_tick"] += 5
        assert sanitize.launch_counts()["stream_tick"] == \
            saved["stream_tick"] + 5
    finally:
        sanitize.set_launch_counts(saved)
    assert sanitize.launch_counts() == saved


# -- tick audit -----------------------------------------------------------
@pytest.mark.parametrize("placement", tick_audit.PLACEMENTS)
@pytest.mark.parametrize("method", tick_audit.METHODS)
def test_tick_audit_is_clean(placement, method):
    config = tick_audit.service_config(placement, method)
    t = tick_audit.audit_plan_tick(config,
                                   tick_audit.where_for(placement, CPU))
    assert t.ok, [v.message for v in t.violations]
    assert t.shards == {"local": 1, "sharded": 4, "multipod": 4}[placement]
    assert t.launches == {} and t.moved == [] and t.host_transfers == []


def _seeded(plan, hazard):
    tick = plan.tick

    def seeded(states, deltas):
        dists, new = tick(states, deltas)
        return hazard(dists, new)

    plan.tick = seeded
    return plan


def _out_of_place(dists, new):
    return dists, new.map_tensors(torch.clone)


def _item(dists, new):
    dists.sum().item()
    return dists, new


def _float64(dists, new):
    dists.double()
    return dists, new


def _collective(dists, new):
    try:
        torch.distributed.all_reduce(dists)
    except (RuntimeError, ValueError):  # no process group here
        pass
    return dists, new


def _launch(dists, new):
    st_ops.LAUNCHES["stream_tick"] += 1
    return dists, new


@pytest.mark.parametrize("hazard,rule", [
    (_out_of_place, "not-in-place"), (_item, "host-transfer-in-tick"),
    (_float64, "dtype-upcast"), (_collective, "unexpected-collective"),
    (_launch, "launch-count")])
def test_tick_audit_catches_a_seeded_hazard(hazard, rule):
    config = tick_audit.service_config("local", "fused_tick")
    saved = sanitize.launch_counts()
    try:
        plan = _seeded(build_plan(config, CPU), hazard)
        t = tick_audit.audit_plan_tick(config, CPU, plan=plan)
    finally:
        sanitize.set_launch_counts(saved)
    assert {v.rule for v in t.violations} == {rule}, t.violations
    if rule == "not-in-place":
        assert len(t.moved) == 5


def test_tick_audit_catches_an_out_of_place_sharded_tick():
    config = tick_audit.service_config("sharded", "sparse_tick")
    where = tick_audit.where_for("sharded", CPU)
    t = tick_audit.audit_plan_tick(
        config, where, plan=_seeded(build_plan(config, where),
                                    lambda d, new: (d, type(new)(
                                        tuple(p.map_tensors(torch.clone)
                                              for p in new.parts),
                                        new.rows))))
    assert {v.rule for v in t.violations} == {"not-in-place"}
    assert len(t.moved) == 4 * 6


def test_migration_audit_is_clean():
    targets = tick_audit.audit_migrations(CPU)
    assert [t.target for t in targets] == [
        "migrate.grow", "migrate.compact", "migrate.truncate",
        "migrate.grow_sparse"]
    assert all(t.ok for t in targets), [t.violations for t in targets]


def test_audit_repo_on_the_cpu_reaches_every_target():
    report = tick_audit.audit_repo(CPU)
    assert report.ok and len(report.targets) == 6 + 4
    assert json.loads(json.dumps(report.to_dict()))["ok"]


# -- smem -----------------------------------------------------------------
def _cfg(**kw):
    base = dict(package="stream_tick", kernel="tick_kernel<false, 8>",
                shape="phase 3", grid=4096, block=256, dyn_smem=21632,
                static_smem=0, registers=64, local_bytes=0,
                max_threads=256, blocks_per_sm=4, smem_limit=232448,
                accepted=True, admitted=True)
    base.update(kw)
    return smem.LaunchConfig(**base)


def test_smem_rules_on_an_injected_table():
    guard = smem.GuardCheck("dispatch.smem_fits('stream_tick')", "k=2000",
                            True, True)
    assert smem.check_launch_configs([_cfg()], [guard],
                                     {"stream_tick": 1}) == []
    cases = {
        "smem-over-limit": [_cfg(dyn_smem=232448, static_smem=16)],
        "no-residency": [_cfg(blocks_per_sm=0)],
        "guard-drift": [_cfg(accepted=False, blocks_per_sm=0)],
    }
    for rule, table in cases.items():
        got = smem.check_launch_configs(table, [], {"x": 1})
        assert {v.rule for v in got} == {rule}, (rule, got)
    # a shape the guards do not admit is reported but never a violation
    assert smem.check_launch_configs(
        [_cfg(dyn_smem=1 << 20, accepted=False, blocks_per_sm=0,
              admitted=False)], [], {}) == []
    drift = smem.GuardCheck("delta_stats.ops.max_fused_k", "k=8193", True,
                            False)
    got = smem.check_launch_configs([], [drift], {"delta_stats": 0})
    assert [v.rule for v in got] == ["guard-drift", "no-launch"]
    assert "k=8193" in got[0].message and "delta_stats" in got[1].message
    report = smem.SmemReport("card", [_cfg()], [guard], {"stream_tick": 1},
                             [])
    assert report.ok and report.to_dict()["configs"][0]["smem"] == 21632
    assert "tick_kernel<false, 8>" in "\n".join(smem.table(report))


def _keys_per_lane(k):
    """`lane_keys(sort_length(k))` of ``csrc/warp_sort.cuh``."""
    n = 64
    while n < 2 * k:
        n <<= 1
    return n // 32 if n <= 256 else 0


def test_smem_tables_cover_every_instantiation():
    for name in ("stream_tick", "sparse_tick"):
        assert {_keys_per_lane(k) for _, _, k, _ in
                smem.TICK_SHAPES[name]} == {0, 2, 4, 8}
    assert {_keys_per_lane(k) for _, _, _, k, _ in smem.SPLIT_SHAPES} == \
        {0, 2, 4, 8}
    # each split shape splits on an H100 (4 blocks an SM × 132 SMs × 8
    # warps), with 8 warps a block or the 4 of a k = 1024 layout
    for _, rows, n, _, _ in smem.SPLIT_SHAPES:
        assert st_ops.warps_per_stream(rows, n, 4 * 132 * 8, 4) > 1
    assert {_keys_per_lane(k) for _, _, k in smem.DELTA_SHAPES
            if k <= 8192} == {0, 2, 4, 8}
    assert {s for _, s in smem.PROBE_SHAPES if s % 4} and \
        {s for _, s in smem.PROBE_SHAPES if s % 4 == 0}
    assert max(k for _, _, k in smem.DELTA_SHAPES) > 8192
    assert {b for _, _, b in smem.BSR_SHAPES} == {64, 128}
    assert set(smem.PARITY_RUNS) == {
        "stream_tick", "sparse_tick", "delta_stats", "vnge_q",
        "entropy_probe", "bsr_spmv"}


def test_smem_refuses_the_cpu_by_name():
    for fn in (smem.run_smem, smem.collect_launch_configs,
               smem.collect_guards):
        with pytest.raises(smem.SmemNeedsCard, match="card"):
            fn(CPU)


# -- sentinel -------------------------------------------------------------
@pytest.mark.parametrize("chain", ["run_migration_chain",
                                   "run_sparse_chain", "run_fleet_chain"])
def test_sentinel_chain_at_zero_first_uses(chain):
    report = getattr(sentinel, chain)(device=CPU)
    assert report["ok"] and report["budget_per_phase"] == 0
    assert set(report["phases"].values()) == {0}


def test_fleet_chain_report_matches_the_reference_keys():
    report = sentinel.run_fleet_chain(device=CPU)
    assert report["pools"] == ["small", "mega", "large", "slots"]
    assert report["launches_steady"] == 4
    assert report["launches_post_compaction"] > 4
    assert report["transfer_budget_scores_per_tick"] == 4


def test_scaled_chain_at_a_cut_size():
    report = sentinel.run_scaled_chain(device=CPU, batch_size=64, n_pad=64,
                                       grow_n_pad=128)
    assert report["ok"] and set(report["phases"].values()) == {0}
    assert report["n_pad"] == [64, 128, 64]


def test_migration_chain_scores_match_the_jax_service():
    got = np.asarray(sentinel.run_migration_chain(device=CPU)["scores"],
                     np.float64)
    config = jserving.ServiceConfig(
        batch_size=jsentinel._B, n_pad=jsentinel._N_PAD,
        k_pad=jsentinel._K_PAD, placement="local", ingestion="sync",
        topk=jserving.TopKSpec(k=2))
    graphs = jsentinel._graphs()
    with jserving.FingerService.open(config, graphs) as svc:
        run = jsentinel._run_ticks
        run(svc, graphs, jsentinel._N_PAD, seeds=[0])
        run(svc, graphs, jsentinel._N_PAD, seeds=range(1, 4))
        svc.repad(jsentinel._GROW_N_PAD)
        run(svc, graphs, jsentinel._GROW_N_PAD, seeds=range(10, 13))
        run(svc, graphs, jsentinel._GROW_N_PAD, seeds=range(20, 23))
        svc.compact(jsentinel._N_PAD)
        run(svc, graphs, jsentinel._N_PAD, seeds=range(30, 33))
        want = np.asarray(svc.scores(), np.float64)
    np.testing.assert_allclose(got ** 2, want ** 2, atol=1e-5, rtol=1e-5)
    big = want ** 2 > 1e-3
    np.testing.assert_allclose(got[big], want[big], atol=1e-5, rtol=1e-5)
    assert (want > 0).all()


# -- the CLI --------------------------------------------------------------
def test_cli_json_report(capsys):
    assert analysis_main(["lint", "audit", "--json", "--device",
                          "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["device"] == "cpu"
    assert set(report["checks"]) == {"lint", "audit"}
    assert report["checks"]["lint"]["ok"]
    assert len(report["checks"]["audit"]["targets"]) == 10


def test_cli_sentinel_text_report(capsys):
    assert analysis_main(["sentinel", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sentinel: OK" in out and "analysis: OK (sentinel on cpu)" in out
    assert "dense_phase3" not in out  # the scaled chain is the card's


def test_cli_smem_on_the_cpu_fails_naming_the_card(capsys):
    assert analysis_main(["smem", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "smem: FAIL" in captured.err and "card" in captured.err


def test_cli_wants_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        analysis_main(["lint"])


def test_benchmark_suite_twin_runs_the_gate(capsys):
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks_torch import run
    finally:
        sys.path.remove(str(ROOT))
    run.main(["--only", "analysis", "--device", "cpu"])
    rows = [line.split(",", 2) for line in
            capsys.readouterr().out.splitlines()[1:]]
    assert [r[0] for r in rows] == ["analysis/lint", "analysis/tick_audit",
                                    "analysis/smem", "analysis/sentinel"]
    assert rows[2][2] == "not run: smem reads the card"
    assert rows[3][2] == "2 generations at 0 first uses"
