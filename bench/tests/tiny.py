"""A cell of the benchmark cut to a size the CPU tests can run: the
configuration of ``as-oregon`` with few streams and small graphs, the
``steady`` mix and the configuration's own limits."""
import copy
import dataclasses

from bench import spec

GRAPH = {"n_live": [100, 110], "edges": 300,
         "src": {"law": "power", "gamma": 3.7},
         "dst": {"law": "power", "gamma": 3.7}, "weight": [0.5, 1.5]}


def cell(batch_size: int = 16, n_pad: int = 128, graph=None) -> spec.Cell:
    base = spec.load_cell("as-oregon.steady")
    cfg = copy.deepcopy(base.config)
    cfg["service"].update(batch_size=batch_size, n_pad=n_pad)
    cfg["graph"] = copy.deepcopy(graph or GRAPH)
    return dataclasses.replace(base, config=cfg)
