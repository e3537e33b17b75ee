"""Checkpoints cross between the packages, and the port resumes.

- The JAX package writes ``{"params", "opt"}`` and the port restores
  it; the port writes and the JAX package restores it. Parameters and
  the AdamW state come back bit-equal, under the same names.
- The prune policies and the numeric step order are the reference's.
- A port run of 12 steps equals one preempted after 6 steps plus a
  resume of 6 (the reference's `test_resume_reproduces_training`, whose
  first run instead trains 6 steps under a 6-step schedule and is held
  to 1e-2), at 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jax_base
from repro.distributed.sharding import NO_SHARDING
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.train import checkpoint as jax_ckpt
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.launch.train import run as pt_run
from repro_torch.models.params import flatten_names
from repro_torch.optim import adamw as pt_adamw
from repro_torch.train import checkpoint as pt_ckpt
from repro_torch.train.fault_tolerance import StragglerMonitor, maybe_resume


def jax_state():
    """A JAX {"params", "opt"} tree after one AdamW update."""
    cfg = jax_base.get_config("granite-moe-3b-a800m").reduced()
    params = jax_init_params(jax_tf.param_defs(cfg, NO_SHARDING),
                             jax.random.PRNGKey(2))
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01), params)
    params, opt, _ = jax_adamw.apply_update(
        params, grads, jax_adamw.init_state(params), jax_adamw.AdamWConfig())
    return {"params": params, "opt": opt}


def port_of(tree):
    opt = tree["opt"]
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    return {"params": interop.params_from_numpy(np_tree(tree["params"]),
                                                "cpu"),
            "opt": interop.opt_state_from_numpy(
                {"step": np.asarray(opt.step), "mu": np_tree(opt.mu),
                 "nu": np_tree(opt.nu)}, "cpu")}


def assert_bit_equal(jax_tree, port_tree):
    want = {k: np.asarray(v)
            for k, v in jax_ckpt._flatten_with_names(jax_tree).items()}
    got = {k: v.numpy() for k, v in flatten_names(port_tree).items()}
    assert list(got) == list(want)  # the same names in the same order
    assert "opt/.step" in got and "params/blocks/L0/attn/wq" in got
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_jax_writes_and_the_port_restores(tmp_path):
    tree = jax_state()
    path = jax_ckpt.save_checkpoint(str(tmp_path), 7, tree,
                                    metadata={"arch": "granite"})
    template = port_of(jax_state())
    restored, manifest = pt_ckpt.restore_checkpoint(path, template)
    assert manifest["step"] == 7 and manifest["metadata"]["arch"] == "granite"
    assert isinstance(restored["opt"], pt_adamw.AdamWState)
    assert_bit_equal(tree, restored)
    tree2, step = maybe_resume(str(tmp_path), template)
    assert step == 7
    assert_bit_equal(tree, tree2)


def test_the_port_writes_and_jax_restores(tmp_path):
    tree = jax_state()
    port_tree = port_of(tree)
    path = pt_ckpt.save_checkpoint(str(tmp_path), 3, port_tree,
                                   metadata={"arch": "granite"})
    assert pt_ckpt.load_manifest(path)["n_arrays"] == len(
        flatten_names(port_tree))
    restored, manifest = jax_ckpt.restore_checkpoint(path, tree)
    assert manifest["step"] == 3
    assert_bit_equal(restored, port_tree)


@pytest.mark.parametrize("policy", [
    2, ("keep_last", 1), ("keep_every_n", 10, 1),
    lambda steps: [s for s in steps if s > 15]])
def test_prune_policies_and_numeric_order_match(tmp_path, policy):
    tree = {"x": np.zeros(2, np.float32)}
    port_tree = interop.params_from_numpy(tree, "cpu")
    kept = []
    for pkg, t, root in ((jax_ckpt, tree, tmp_path / "jax"),
                         (pt_ckpt, port_tree, tmp_path / "port")):
        for step in (5, 10, 20, 100000000, 9):
            pkg.save_checkpoint(str(root), step, t, prune_policy=policy)
        kept.append((sorted(os.listdir(root)),
                     os.path.basename(pkg.latest_checkpoint(str(root)))))
    assert kept[0] == kept[1]
    with pytest.raises(ValueError, match="unknown prune_policy"):
        pt_ckpt.save_checkpoint(str(tmp_path / "bad"), 1, port_tree,
                                prune_policy=("keep_some",))


class Preempted(RuntimeError):
    pass


def preempt_at_step_6(line):
    """A log that kills the run once step 6 is done, after the step-6
    checkpoint was written and before step 7's."""
    if line.startswith('{"step": 6,'):
        raise Preempted(line)


def test_resume_reproduces_training(tmp_path):
    cfg = pt_base.get_config("qwen1.5-0.5b").reduced()
    kw = dict(batch_size=4, seq=32, probe_every=0, device="cpu")
    _, _, h_full = pt_run(cfg, steps=12, log=lambda *a: None, **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(Preempted):
        pt_run(cfg, steps=12, ckpt_dir=ck, ckpt_every=6,
               log=preempt_at_step_6, **kw)
    assert os.listdir(ck) == ["step_00000006"]
    _, _, h_resumed = pt_run(cfg, steps=12, ckpt_dir=ck, ckpt_every=100,
                             log=lambda *a: None, **kw)
    assert [h["step"] for h in h_resumed] == list(range(6, 12))
    for a, b in zip(h_full[6:], h_resumed):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-5, atol=1e-5)


def test_straggler_monitor_matches_the_reference(monkeypatch):
    import time

    from repro.train.fault_tolerance import StragglerMonitor as JaxMonitor

    times = [0.1, 0.11, 0.1, 0.12, 0.1, 0.5, 0.1, 0.1, 0.9]
    a, b = StragglerMonitor(), JaxMonitor()
    assert [a.stop(dt) for dt in times] == [b.stop(dt) for dt in times]
    assert (a.flagged, a.mean, a.var) == (b.flagged, b.mean, b.var)
    # start() / stop() with no argument time the step on the host clock:
    # a clock that advances by each step's time between the two calls
    now = [1000.0]

    def clock():
        return now[0]

    monkeypatch.setattr(time, "perf_counter", clock)
    flags = {}
    for name, mon in (("port", StragglerMonitor()), ("jax", JaxMonitor())):
        got = []
        for dt in times:
            mon.start()
            now[0] += dt
            got.append(mon.stop())
        flags[name] = (got, mon.flagged, mon.mean, mon.var, mon.n)
    assert flags["port"] == flags["jax"]
    assert flags["port"][1] > 0
    with pytest.raises(RuntimeError, match="start"):
        StragglerMonitor().stop()
