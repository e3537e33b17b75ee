"""The bytes a tick's inputs need, counted by hand on a tiny case, for
the dense tick and for the sparse tick."""
import numpy as np

from bench.roofline import bytes_needed, sparse_bytes_needed


def test_bytes_needed_by_hand():
    n_pad, k, j = 10, 3, 2
    senders = np.array([[1, 2, 0], [0, 0, 0], [4, 5, 0]], np.int32)
    receivers = np.array([[2, 3, 0], [0, 0, 0], [5, 6, 0]], np.int32)
    dw = np.array([[0.5, 0.0, 0.0], [0, 0, 0], [-1.0, 0.25, 0.0]],
                  np.float32)
    mask = np.array([[1, 1, 0], [0, 0, 0], [1, 1, 0]], np.float32)
    node_ids = np.array([[7, 0], [0, 0], [0, 0]], np.int32)
    node_flag = np.array([[1, 0], [0, 0], [0, 0]], np.float32)
    # rows, scalars, delta, score
    fixed = 2 * n_pad * 4 + 24 + 20 * k + 8 * j + 4
    # stream 0: the changed lane's endpoints {1, 2} and the joined node 7
    # (the lane with dw = 0 changes nothing); stream 1 sends an empty
    # delta: its score alone; stream 2: endpoints {4, 5, 6}
    want = (fixed + 4 * 3) + 4 + (fixed + 4 * 3)
    assert bytes_needed(senders, receivers, dw, mask, node_ids, node_flag,
                        n_pad) == want == 396


def test_a_flag_alone_makes_a_delta_non_empty():
    z = np.zeros((1, 2), np.float32)
    zi = np.zeros((1, 2), np.int32)
    flag = np.array([[-1, 0]], np.float32)
    ids = np.array([[3, 0]], np.int32)
    assert bytes_needed(zi, zi, z, z, ids, flag, 4) \
        == 2 * 4 * 4 + 24 + 40 + 16 + 4 + 4
    assert bytes_needed(zi, zi, z, z, ids, z, 4) == 4


def test_sparse_bytes_needed_by_hand():
    n_slots, k, j = 10, 3, 2
    senders = np.array([[1, 2, 0], [0, 0, 0], [4, 5, 0]], np.int32)
    receivers = np.array([[2, 3, 0], [0, 0, 0], [5, 6, 0]], np.int32)
    dw = np.array([[0.5, 0.0, 0.0], [0, 0, 0], [-1.0, 0.25, 0.0]],
                  np.float32)
    mask = np.array([[1, 1, 0], [0, 0, 0], [1, 1, 0]], np.float32)
    node_ids = np.array([[7, 0], [0, 0], [0, 0]], np.int32)
    node_flag = np.array([[1, 0], [0, 0], [0, 0]], np.float32)
    # rows, scalars, the delta with its edge slots, score
    fixed = 2 * n_slots * 4 + 24 + 24 * k + 8 * j + 4
    # stream 0: row elements {1, 2} and the joined 7, and both live
    # lanes write their edge (the dw = 0 lane too: it names its slot);
    # stream 1 sends an empty delta: its score alone; stream 2: row
    # elements {4, 5, 6} and two edges
    want = (fixed + 4 * 3 + 4 * 2) + 4 + (fixed + 4 * 3 + 4 * 2)
    assert sparse_bytes_needed(senders, receivers, dw, mask, node_ids,
                               node_flag, n_slots) == want == 436
    # an empty delta costs the sparse tick its score alone too
    z, zi = np.zeros((1, 2), np.float32), np.zeros((1, 2), np.int32)
    assert sparse_bytes_needed(zi, zi, z, z, zi, z, n_slots) == 4
