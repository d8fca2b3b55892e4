"""Port parity: ``IterativeConnectedComponents`` of the PyTorch port
against the JAX package on the CPU.

The same streams go to both; every record block (vertex, componentId),
batch by batch, and ``final_labels`` must be equal exactly.  The port's
fold (``ops/spmv.cc_fixpoint`` = ``unionfind.union_edges_with_seen``)
updates its labels in place; ``run`` keeps the previous batch's labels as
a host copy, which these streams would catch if it aliased them.
"""

import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import iterative_connected_components as j_example
from gelly_streaming_tpu.library.iterative_cc import IterativeConnectedComponents as JIterative
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import iterative_connected_components as t_example
from gelly_streaming_tpu_torch.library import IterativeConnectedComponents as TIterative

CPU = "cpu"


def _blocks(algo, stream):
    return [tuple(np.asarray(col) for col in b.columns) for b in algo.run(stream).blocks()]


def _both(edges, capacity=16, batch_size=1):
    j, t = JIterative(), TIterative()
    want = _blocks(j, JStream.from_collection(edges, JConfig(vertex_capacity=capacity, max_degree=16),
                                              batch_size=batch_size))
    got = _blocks(t, TStream.from_collection(edges, TConfig(vertex_capacity=capacity, max_degree=16),
                                             batch_size=batch_size, device=CPU))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
            assert gc.dtype == wc.dtype
    np.testing.assert_array_equal(t.final_labels, np.asarray(j.final_labels))
    return t, got


def test_labels_converge_to_min_component_id():
    t, blocks = _both([(1, 2), (3, 4), (2, 3), (6, 7)])
    last = {}
    for vids, labels in blocks:
        last.update(zip(vids.tolist(), labels.tolist()))
    assert last == {1: 1, 2: 1, 3: 1, 4: 1, 6: 6, 7: 6}
    assert t.final_labels[4] == 1 and t.final_labels[7] == 6


def test_merge_reemits_relabeled_vertices():
    _, blocks = _both([(1, 2), (3, 4), (2, 3)])
    recs = [r for vids, labels in blocks for r in zip(vids.tolist(), labels.tolist())]
    assert (3, 3) in recs and (3, 1) in recs and (4, 1) in recs


@pytest.mark.parametrize("seed,batch", [(0, 1), (1, 4), (2, 16), (3, 7)])
def test_random_streams_match_jax(seed, batch):
    rng = np.random.default_rng(seed)
    edges = [(int(rng.integers(0, 40)), int(rng.integers(0, 40))) for _ in range(60)]
    _both(edges, capacity=64, batch_size=batch)


def test_example_csv_matches_jax(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("1 2\n3 4\n2 3\n6 7\n5 5\n")
    j_example.main([str(path), str(tmp_path / "j.csv")])
    t_example.main(["--device=cpu", str(path), str(tmp_path / "t.csv")])
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert (tmp_path / "t.csv").read_text()
