"""Port parity: the bipartiteness check of the PyTorch port against the JAX
package on the CPU.

The parity union-find state (``parent2``, ``seen``), the conflicts and
verdicts, and the ``Candidates`` strings (BipartitenessCheckTest.java
goldens) must be identical on every path the port routes: one window, many
windows merged (with round-robin partitions), the wire path over
array-backed and replayed EF40 streams, and the example's CSV bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.io import sources as jsources
from gelly_streaming_tpu.library import bipartiteness as jbp
from gelly_streaming_tpu.ops import unionfind as juf
from gelly_streaming_tpu.summaries.candidates import Candidates as JCandidates
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.io import sources as tsources
from gelly_streaming_tpu_torch.io import wire as twire
from gelly_streaming_tpu_torch.library import bipartiteness as tbp
from gelly_streaming_tpu_torch.ops import unionfind as tuf
from gelly_streaming_tpu_torch.summaries.candidates import Candidates as TCandidates

# the wire path runs the prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"
KW = dict(vertex_capacity=16, max_degree=16)
# BipartitenessCheckTest.java:70-90
BIPARTITE_EDGES = [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)]
NON_BIPARTITE_EDGES = [(1, 2), (2, 3), (3, 1), (4, 5), (5, 7), (4, 1)]
BIPARTITE_GOLDEN = (
    "(true,{1={1=(1,true), 2=(2,false), 3=(3,false), 4=(4,false), "
    "5=(5,true), 7=(7,true), 9=(9,true)}})"
)


def _assert_same_records(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(t.parent2.numpy(), np.asarray(j.parent2))
        np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))
        assert str(t) == str(j)
        assert t.is_bipartite() == j.is_bipartite()


@pytest.mark.parametrize("bs", [None, 1, 3, 6])
def test_goldens_match_jax(bs):
    for edges, golden in ((BIPARTITE_EDGES, BIPARTITE_GOLDEN), (NON_BIPARTITE_EDGES, "(false,{})")):
        t = TStream.from_collection(edges, TConfig(**KW), batch_size=bs, device=CPU)
        j = JStream.from_collection(edges, JConfig(**KW), batch_size=bs)
        t_recs = t.aggregate(tbp.BipartitenessCheck(window_ms=500)).collect()
        _assert_same_records(t_recs, j.aggregate(jbp.BipartitenessCheck(window_ms=500)).collect())
        assert [str(r[0]) for r in t_recs] == [golden]


def _bipartite_edges(rng, n, c, odd_cycles=0):
    src = rng.integers(0, c // 2, n) * 2
    dst = rng.integers(0, c // 2, n) * 2 + 1
    src[:odd_cycles] = rng.integers(0, c, odd_cycles)
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("start", ["identity", "forest"])
def test_parity_union_matches_jax_from_a_shared_state(start):
    rng = np.random.default_rng(3)
    c, n = 64, 80
    src, dst = _bipartite_edges(rng, n, c, odd_cycles=2)
    mask = rng.random(n) < 0.8
    parent2 = np.arange(2 * c, dtype=np.int32)
    seen = np.zeros(c, bool)
    if start == "forest":
        s0, d0 = _bipartite_edges(rng, 30, c)
        j0 = juf.parity_union_edges(jnp.asarray(parent2), jnp.asarray(s0), jnp.asarray(d0))
        parent2 = np.asarray(j0)
        seen[s0] = seen[d0] = True
    state = interop.bp_state_from_numpy(parent2, seen, device=CPU)
    t_p, t_s = tuf.parity_union_edges_with_seen(state.parent2, state.seen, *map(torch.from_numpy, (src, dst, mask)))
    j_agg = jbp.BipartitenessCheck()
    j_state = j_agg.update(jbp.BPState(jnp.asarray(parent2), jnp.asarray(seen)), *map(jnp.asarray, (src, dst)), None,
                           jnp.asarray(mask))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_state.parent2))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_state.seen))
    np.testing.assert_array_equal(tuf.parity_conflicts(t_p, t_s).numpy(),
                                  np.asarray(juf.parity_conflicts(j_state.parent2, j_state.seen)))
    assert bool(tuf.is_bipartite(t_p, t_s)) == bool(juf.is_bipartite(j_state.parent2, j_state.seen))
    want = juf.parity_union_edges(jnp.asarray(parent2), *map(jnp.asarray, (src, dst, mask)))
    got = tuf.parity_union_edges(torch.from_numpy(parent2.copy()), *map(torch.from_numpy, (src, dst, mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert str(TCandidates(t_p, t_s)) == str(JCandidates(j_state.parent2, j_state.seen))
    with pytest.raises(ValueError):
        interop.bp_state_from_numpy(np.arange(6), np.zeros(4, bool), device=CPU)


def _timed_edges(seed, n, cap, windows, bipartite):
    rng = np.random.default_rng(seed)
    if bipartite:
        src, dst = _bipartite_edges(rng, n, cap)
    else:
        src, dst = rng.integers(0, cap, n), rng.integers(0, cap, n)
    tim = np.sort(rng.integers(0, windows * 100, n))
    return [(int(s), int(d), 0, int(t)) for s, d, t in zip(src, dst, tim)]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("bipartite", [True, False])
def test_windowed_path_matches_jax(shards, bipartite):
    """Timed windows folded per round-robin partition, combined and merged
    across windows (merge_parents on the doubled space)."""
    edges = _timed_edges(shards, 120 if bipartite else 30, 64, 4, bipartite)
    kw = dict(vertex_capacity=64, num_shards=shards)
    t = TStream.from_collection(edges, TConfig(**kw), batch_size=16, with_time=True, device=CPU)
    j = JStream.from_collection(edges, JConfig(**kw), batch_size=16, with_time=True)
    t_recs = t.aggregate(tbp.BipartitenessCheck(window_ms=100)).collect()
    _assert_same_records(t_recs, j.aggregate(jbp.BipartitenessCheck(window_ms=100)).collect())
    assert len(t_recs) == 4
    if bipartite:
        assert str(t_recs[-1][0]).startswith("(true,")


def test_wire_paths_match_jax():
    rng = np.random.default_rng(7)
    for bipartite in (True, False):
        src, dst = _bipartite_edges(rng, 1100, 512) if bipartite else (
            rng.integers(0, 512, 300).astype(np.int32), rng.integers(0, 512, 300).astype(np.int32))
        kw = dict(vertex_capacity=512, batch_size=128, wire_encoding="ef40", ingest_window_edges=256)
        t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
        agg = tbp.BipartitenessCheck()
        assert agg._wire_eligible(t) and agg._wire_width(t.cfg, 128) == (twire.EF40, 512)
        j = JStream.from_arrays(src, dst, JConfig(**kw))
        t_recs = t.aggregate(agg).collect()
        _assert_same_records(t_recs, j.aggregate(jbp.BipartitenessCheck()).collect())
        assert t_recs[-1][0].is_bipartite() == bipartite
        width = (twire.EF40, 512)
        bufs, tail = twire.pack_stream(src, dst, 128, width)
        t = TStream.from_wire(bufs, 128, width, TConfig(vertex_capacity=512), tail=tail, device=CPU)
        j = JStream.from_wire(bufs, 128, width, JConfig(vertex_capacity=512), tail=tail)
        _assert_same_records(t.aggregate(agg).collect(), j.aggregate(jbp.BipartitenessCheck()).collect())


@pytest.mark.parametrize("with_file", [False, True])
def test_bipartiteness_example_matches_jax(tmp_path, capsys, with_file):
    from gelly_streaming_tpu.examples import bipartiteness_check as j_example

    from gelly_streaming_tpu_torch.examples import bipartiteness_check as t_example

    if with_file:
        p = tmp_path / "edges.txt"
        p.write_text("".join(f"{s} {d} 0 {t}\n" for s, d, _, t in _timed_edges(5, 60, 40, 3, True)))
        t_out, j_out = tmp_path / "t.csv", tmp_path / "j.csv"
        t_example.main(["--device=cpu", str(p), str(t_out), "100"])
        j_example.main([str(p), str(j_out), "100"])
        assert t_out.read_bytes() == j_out.read_bytes()
        assert t_out.read_text().count("(true,") == 3
    else:
        t_example.main(["--device=cpu"])
        t_lines = capsys.readouterr().out.splitlines()
        j_example.main([])
        assert t_lines[3:] == capsys.readouterr().out.splitlines()[3:] == ["(false,{})"]


# ids outside [0, C) on the streams that validate nothing: the doubled ids
# 2u, 2u + 1 clamp into [0, 2C) after a negative wrap, so both sides of an
# id >= C land on node 2C - 1 and -1 maps to 2C - 2 / 2C - 1
OOR_EDGES = {
    "bipartite": [(1, 2), (3, 16), (-1, 4), (5, 21), (6, 7)],
    "odd": [(1, 2), (16, 3), (-1, 4), (21, 1), (5, -1), (15, 16), (2, 5)],
}


@pytest.mark.parametrize("edges", sorted(OOR_EDGES))
@pytest.mark.parametrize("source,bs", [("collection", None), ("batches", 3)])
def test_out_of_range_ids_follow_jax_index_rules(edges, source, bs):
    edges = OOR_EDGES[edges]
    if source == "collection":
        t = TStream.from_collection(edges, TConfig(**KW), device=CPU)
        j = JStream.from_collection(edges, JConfig(**KW))
    else:
        src, dst = (np.array([e[k] for e in edges], np.int32) for k in (0, 1))
        t = TStream.from_batches(tsources._batched(src, dst, None, None, None, bs, CPU), TConfig(**KW), device=CPU)
        j = JStream.from_batches(jsources._batched(src, dst, None, None, None, bs), JConfig(**KW))
    t_recs = t.aggregate(tbp.BipartitenessCheck(window_ms=500)).collect()
    _assert_same_records(t_recs, j.aggregate(jbp.BipartitenessCheck(window_ms=500)).collect())

