"""The port's host-side graph functions are array-equal to the JAX package's.

`repro_torch` keeps its own numpy copies of the graph generators, the
partitioner, the blocked adjacency and the dataflow chooser; on seeded
graphs every output must be `np.array_equal` to the reference's, including
the padding columns of the tile table that repeat the last valid id.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dataflow as j_dataflow, partition as j_partition
from repro.graph import generators as j_gen, structure as j_struct
from repro_torch.core import dataflow, partition
from repro_torch.graph import generators, structure

GRAPHS = [(300, 900, 0), (1000, 5000, 1), (257, 800, 2), (4096, 16384, 3)]


def _edges(n, e, seed):
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    return ei, r.standard_normal(e).astype(np.float32)


def _same_blocked(a, b):
    for f in ("block_vals", "block_cols", "row_nnzb"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.n_nodes, a.block, a.n_col_nodes) == (b.n_nodes, b.block, b.n_col_nodes)
    assert (a.nnz_blocks, a.max_nnzb, a.n_padded, a.n_col_padded) == (
        b.nnz_blocks, b.max_nnzb, b.n_padded, b.n_col_padded)
    assert a.padded_tile_fraction == b.padded_tile_fraction and a.density == b.density


@pytest.mark.parametrize("n,e,seed", GRAPHS)
def test_blocked_adjacency_equal(n, e, seed):
    ei, w = _edges(n, e, seed)
    _same_blocked(structure.blocked_adjacency(n, ei, w), j_struct.blocked_adjacency(n, ei, w))
    _same_blocked(structure.blocked_adjacency(n, ei), j_struct.blocked_adjacency(n, ei))


def test_blocked_adjacency_rectangular_and_block_size_equal():
    ei, w = _edges(300, 1200, 4)
    ei[0] += 100                                   # senders in a wider column space
    _same_blocked(structure.blocked_adjacency(300, ei, w, n_col_nodes=400),
                  j_struct.blocked_adjacency(300, ei, w, n_col_nodes=400))
    _same_blocked(structure.blocked_adjacency(300, ei, w, block=64, n_col_nodes=400),
                  j_struct.blocked_adjacency(300, ei, w, block=64, n_col_nodes=400))


@pytest.mark.parametrize("n,e,seed", GRAPHS)
def test_blocked_stats_equal(n, e, seed):
    ei, _ = _edges(n, e, seed)
    assert structure.blocked_stats(n, ei) == j_struct.blocked_stats(n, ei)


@pytest.mark.parametrize("method", ["bfs", "partition"])
@pytest.mark.parametrize("n,e,seed", GRAPHS)
def test_locality_block_order_equal(method, n, e, seed):
    ei, _ = _edges(n, e, seed)
    np.testing.assert_array_equal(structure.locality_block_order(n, ei, method=method, seed=seed),
                                  j_struct.locality_block_order(n, ei, method=method, seed=seed))


def test_locality_block_order_small_graph_and_bad_method():
    ei, _ = _edges(100, 300, 5)
    np.testing.assert_array_equal(structure.locality_block_order(100, ei), np.arange(100))
    with pytest.raises(ValueError, match="unknown locality method"):
        structure.locality_block_order(300, _edges(300, 900, 0)[0], method="spectral")


@pytest.mark.parametrize("n,e,seed", GRAPHS)
def test_bfs_traversal_order_equal(n, e, seed):
    ei, _ = _edges(n, e, seed)
    np.testing.assert_array_equal(partition.bfs_traversal_order(n, ei[0], ei[1]),
                                  j_partition.bfs_traversal_order(n, ei[0], ei[1]))


@pytest.mark.parametrize("method,refine", [("block", False), ("random", False), ("bfs", False), ("bfs", True)])
def test_partition_graph_equal(method, refine):
    g = j_gen.citation_like(2000, 8000, n_labels=8, seed=2)
    a = partition.partition_graph(2000, g.edge_index, 16, method=method, seed=1, refine=refine)
    b = j_partition.partition_graph(2000, g.edge_index, 16, method=method, seed=1, refine=refine)
    np.testing.assert_array_equal(a.assignment, b.assignment)
    np.testing.assert_array_equal(a.edge_counts, b.edge_counts)
    np.testing.assert_array_equal(a.part_sizes, b.part_sizes)
    assert (a.k, a.n_nodes, a.n_edges) == (b.k, b.n_nodes, b.n_edges)


@pytest.mark.parametrize("kw", [dict(n_nodes=500, n_edges=2000, n_features=33, n_labels=5, seed=0),
                                dict(n_nodes=1500, n_edges=9000, n_features=None, seed=4, homophily=0.9),
                                dict(n_nodes=700, n_edges=3000, n_features=12, feature_dtype=np.float16,
                                     with_positions=True, seed=7)])
def test_citation_like_equal(kw):
    a, b = generators.citation_like(**kw), j_gen.citation_like(**kw)
    for f in ("edge_index", "features", "labels", "positions"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed", "extcora", "nell"])
def test_make_dataset_reduced_equal(name):
    (sa, a), (sb, b) = generators.make_dataset(name, reduced=True), j_gen.make_dataset(name, reduced=True)
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
    for f in ("edge_index", "features", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_table_i_equal():
    assert {k: dataclasses.asdict(v) for k, v in generators.TABLE_I.items()} == {
        k: dataclasses.asdict(v) for k, v in j_gen.TABLE_I.items()}


def test_graph_data_transforms_equal():
    g = generators.citation_like(600, 2400, seed=3)
    jg = j_gen.citation_like(600, 2400, seed=3)
    a, b = g.symmetrized().with_self_loops(), jg.symmetrized().with_self_loops()
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    np.testing.assert_array_equal(a.sym_normalized_weights(), b.sym_normalized_weights())
    w = np.ones(g.n_edges, np.float32)
    np.testing.assert_array_equal(dataclasses.replace(g, edge_weight=w).with_self_loops().edge_weight,
                                  dataclasses.replace(jg, edge_weight=w).with_self_loops().edge_weight)


def test_permutation_helpers_equal():
    ei, _ = _edges(500, 2000, 6)
    perm = structure.locality_block_order(500, ei)
    np.testing.assert_array_equal(structure.permute_edge_index(perm, ei), j_struct.permute_edge_index(perm, ei))
    x = np.random.default_rng(0).standard_normal((500, 3)).astype(np.float32)
    np.testing.assert_array_equal(structure.relocate_rows(perm, x), j_struct.relocate_rows(perm, x))
    np.testing.assert_array_equal(structure.restore_rows(perm, structure.relocate_rows(perm, x)), x)


def test_device_forms_equal():
    g = generators.citation_like(400, 1500, seed=1)
    jg = j_gen.citation_like(400, 1500, seed=1)
    w = g.symmetrized().sym_normalized_weights()
    a = structure.to_padded(g.symmetrized(), pad_to=4000, weights=w, device="cpu")
    b = j_struct.to_padded(jg.symmetrized(), pad_to=4000, weights=w)
    for f in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)
    assert (a.n_nodes, a.n_real_edges, a.n_edges_padded) == (b.n_nodes, b.n_real_edges, b.n_edges_padded)
    ba = structure.blocked_adjacency(400, g.edge_index)
    vals, cols, lens = ba.arrays(device="cpu")
    assert (vals.dtype, cols.dtype, lens.dtype) == (torch.float32, torch.int32, torch.int32)
    for t, ref in zip((vals, cols, lens), j_struct.blocked_adjacency(400, jg.edge_index).arrays()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="pad_to"):
        structure.to_padded(g, pad_to=10, device="cpu")


def test_arrays_rejects_column_ids_out_of_range():
    ba = structure.blocked_adjacency(300, _edges(300, 900, 0)[0])
    ba.block_cols[0, 0] = ba.n_block_cols
    with pytest.raises(ValueError, match="block_cols"):
        ba.arrays(device="cpu")


@pytest.mark.parametrize("n,d_in,d_out,nnz", [(2708, 1433, 16, 900), (65755, 16, 210, 11662),
                                              (100, 8, 8, 3), (1000, 4, 64, 50)])
def test_choose_order_equal(n, d_in, d_out, nnz):
    for kw in (dict(n_edges=5 * n), dict(), dict(backend="bsr", nnz_blocks=nnz), dict(backend="bsr")):
        assert dataflow.choose_order(n, d_in, d_out, **kw) == j_dataflow.choose_order(n, d_in, d_out, **kw)
    for fn in ("dense_multiply_count", "blocked_multiply_count"):
        args = (n, d_in, d_out) if fn == "dense_multiply_count" else (n, nnz, d_in, d_out)
        a, b = getattr(dataflow, fn)(*args), getattr(j_dataflow, fn)(*args)
        assert (a.aggregation_first, a.feature_first, a.reduction) == (b.aggregation_first, b.feature_first, b.reduction)
    a, b = dataflow.sparse_multiply_count(n, 5 * n, d_in, d_out), j_dataflow.sparse_multiply_count(n, 5 * n, d_in, d_out)
    assert (a.aggregation_first, a.feature_first, a.best) == (b.aggregation_first, b.feature_first, b.best)
