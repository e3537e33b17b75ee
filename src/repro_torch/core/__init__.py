"""FINGER core of the port: exact VNGE, the Lemma-1 proxy Q, FINGER-Ĥ
(eq. 1) and FINGER-H̃ (eq. 2), Theorem-2 incremental updates, the
Jensen–Shannon distance Algorithms 1 and 2, the Theorem-1 bounds and the
sparse slot-space path."""
from repro_torch.core.vnge import (
    exact_vnge,
    quadratic_q,
    strength_stats,
    vnge_hat,
    vnge_tilde,
)
from repro_torch.core.state import FingerState, finger_state
from repro_torch.core.incremental import (
    delta_stats,
    delta_stats_compact,
    h_tilde_after,
    update_state,
)
from repro_torch.core.jsdist import (
    average_graph,
    js_distance,
    jsdist_exact,
    jsdist_fast,
    jsdist_incremental,
    jsdist_stream,
    jsdist_tilde,
)
from repro_torch.core.bounds import (
    scaled_approximation_error,
    theorem1_bounds,
)
from repro_torch.core.sparse import (
    SlotMap,
    SparseCapacityError,
    SparseLayout,
    SparseStreamState,
    sparse_jsdist_tick,
    sparse_state_from_graph,
    sparse_states_from_graphs,
)

__all__ = [
    "exact_vnge", "quadratic_q", "vnge_hat", "vnge_tilde", "strength_stats",
    "FingerState", "finger_state", "update_state", "h_tilde_after",
    "delta_stats", "delta_stats_compact",
    "average_graph", "js_distance", "jsdist_fast",
    "jsdist_exact", "jsdist_tilde", "jsdist_incremental", "jsdist_stream",
    "theorem1_bounds", "scaled_approximation_error",
    "SparseLayout", "SparseStreamState", "SlotMap",
    "SparseCapacityError", "sparse_jsdist_tick",
    "sparse_state_from_graph", "sparse_states_from_graphs",
]
