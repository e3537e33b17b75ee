"""The dense tiny cell reads what it read before the harness learnt the
sparse path: its cycle of deltas, the bytes each tick needs, the streams
and the tick it samples, and the numbers it judges, at one seed."""
import hashlib

import pytest
import torch

from bench import harness, spec
from bench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77
DELTAS = "b74a0a243a636389e6b49c6cdd5e23ab01ce7cad6d4860c996da86449cbc80e6"
BYTES = [20156, 20168, 18808, 20180, 20172, 20156, 20052, 20112, 20112,
         20052, 20156, 20172, 20180, 18808, 20168, 20156]
NUMBERS = {"score_gap": 0.0002385148109375114, "state_gap": 0.0,
           "smax_gap": 0.0, "q_gap": 8.537713236389521e-08,
           "mask_gap": 0.0, "score_max": 0.005641709081828594,
           "ref_score_max": 0.005647912395341703, "topk_gap": 0}


def test_the_dense_cell_reads_as_before():
    cell = tiny.cell()
    inputs = harness.make_inputs(cell.config, cell.mix, SEED, CPU)
    digest = hashlib.sha256()
    for f in sorted(inputs.host):
        digest.update(f.encode())
        digest.update(inputs.host[f].numpy().tobytes())
    assert digest.hexdigest() == DELTAS
    assert [inputs.bytes_needed(t) for t in range(16)] == BYTES

    inputs, svc, loop = harness.serve(cell, SEED, CPU)
    assert loop.sample.tolist() == list(range(16))
    assert loop.scalar_sample.tolist() == list(range(16))
    assert loop.judge_phase == 6
    for _ in range(40):
        loop.step()
    loop.align(int(cell.mix["cycle_ticks"]))
    out = harness.Outputs.collect(svc, loop)
    assert (len(out.judged), out.final_tick, out.maps) == (2, 72, None)
    numbers, _ = harness.program_numbers(cell.config, SEED, inputs.host,
                                         out, CPU)
    assert numbers == pytest.approx(NUMBERS, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("config, want", [
    ("as-oregon", 65_536), ("amazon-copurchase", 1_739), (None, 16)])
def test_the_scalar_sample_holds_a_bounded_number_of_edges(config, want):
    cfg = spec.load_config(config) if config else tiny.cell().config
    assert harness.scalar_streams(cfg) == want
