"""A cell of the benchmark cut to a size the CPU tests can run: the
configuration of ``as-oregon`` with few streams and small graphs, the
``steady`` mix and the configuration's own limits; and the same cell
served by ``sparse_tick`` over a virtual id space, with a limit for its
edge store."""
import copy
import dataclasses

from bench import spec

GRAPH = {"n_live": [100, 110], "edges": 300,
         "src": {"law": "power", "gamma": 3.7},
         "dst": {"law": "power", "gamma": 3.7}, "weight": [0.5, 1.5]}
EDGE_GAP = 1e-5  # the program's edge store is exact; bfloat16 is not


def cell(batch_size: int = 16, n_pad: int = 128, graph=None) -> spec.Cell:
    base = spec.load_cell("as-oregon.steady")
    cfg = copy.deepcopy(base.config)
    cfg["service"].update(batch_size=batch_size, n_pad=n_pad)
    cfg["graph"] = copy.deepcopy(graph or GRAPH)
    return dataclasses.replace(base, config=cfg)


def sparse_cell(batch_size: int = 16, n_slots: int = 128, m_pad: int = 512,
                n_virtual: int = 4096, graph=None) -> spec.Cell:
    """The tiny cell with ``n_slots`` node slots and ``m_pad`` edge-store
    slots a stream over ``n_virtual`` ids."""
    c = cell(batch_size, n_virtual, graph)
    c.config["service"].update(method="sparse_tick", n_slots=n_slots,
                               m_pad=m_pad)
    c.config["limits"]["edge_gap"] = EDGE_GAP
    return c
