"""Graph substrate of the port: layouts, representations, Laplacian ops,
spectra, generators and stream synthesizers."""
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.laplacian import (
    laplacian_dense,
    laplacian_matvec,
    normalized_laplacian_dense,
    trace_l,
)
from repro_torch.graphs.spectral import (
    exact_eigvals_ln,
    lmax_lmin_positive,
    power_iteration_lmax,
)
from repro_torch.graphs.types import (
    DenseGraph,
    EdgeList,
    GraphDelta,
    apply_delta_dense,
    gate_delta_by_nodes,
    node_mask_after_joins,
    node_mask_after_leaves,
)
