"""The training example's twin
(`examples_torch/train_with_entropy_probe.py`) against the reference
example's printed structure, on the CPU.

The reference example is imported and run as it is (`sys.argv` set to
the flags) and its output captured with `capsys`; the twin runs on CPU
tensors with the same flags: 6 steps of batch 2 × seq 16, so that the
example's probe steps 0 and 5 give a routing-distance line. The loss
line and the routing-distance line must have the reference's structure;
the losses are not compared (the two packages draw their initial
weights differently, ROADMAP Queue 3). This is a file of its own
because the reference's compile alone takes about 18 s here.
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # `examples` and `examples_torch`
    sys.path.insert(0, str(ROOT))

from examples import train_with_entropy_probe as ref_train  # noqa: E402
from examples_torch import train_with_entropy_probe  # noqa: E402


def reference_out(capsys, monkeypatch, module, argv=()) -> str:
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def test_train_with_entropy_probe_prints_the_reference_lines(
        capsys, monkeypatch, tmp_path):
    flags = ["--steps", "6", "--batch", "2", "--seq", "16"]
    ref = reference_out(capsys, monkeypatch, ref_train,
                        [*flags, "--ckpt-dir", str(tmp_path / "ref")])
    history = train_with_entropy_probe.main(
        [*flags, "--ckpt-dir", str(tmp_path / "twin"), "--device", "cpu"])
    twin = capsys.readouterr().out

    def tail(out):
        lines = out.strip().splitlines()
        loss = next(s for s in lines if s.startswith("loss trajectory:"))
        routing = [s for s in lines
                   if s.startswith("routing-graph JS distances:")]
        return loss, routing

    (ref_loss, ref_routing), (loss, routing) = tail(ref), tail(twin)
    assert loss.count("->") == ref_loss.count("->") == 5
    assert len(routing) == len(ref_routing) == 1
    assert len(routing[0].split()) == len(ref_routing[0].split()) == 4
    assert [h["step"] for h in history] == list(range(6))
    assert all(np.isfinite(h["loss"]) for h in history)
    probes = [h for h in history if "attn_entropy_mean" in h]
    assert [h["step"] for h in probes] == [0, 5]
    # a second run resumes from the final checkpoint: no step is left
    again = train_with_entropy_probe.main(
        [*flags, "--ckpt-dir", str(tmp_path / "twin"), "--device", "cpu"])
    assert again == []
