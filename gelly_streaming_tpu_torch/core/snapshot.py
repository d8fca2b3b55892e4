"""SnapshotStream: per-vertex-keyed windowed neighborhood views.

Port of ``gelly_streaming_tpu/core/snapshot.py``'s synchronous
single-device path.  ``EdgeStream.slice()`` (reference
SimpleEdgeStream.java:135-167) makes one; each closed pane ships to the
stream's device as its padded edge list and is grouped there into
degree-bucketed neighborhoods (``ops/neighborhoods.build_buckets``,
``csrc/neighborhoods.cu`` on the GPU).  The three aggregations of the
reference (SnapshotStream.java:61-181) run the user's function over them:

* ``fold_neighbors`` and ``reduce_on_edges``: the JAX package's
  ``lax.scan`` over a row's D neighbor slots becomes a loop over the
  bucket's D columns, each step the user's function vmapped
  (``torch.func.vmap``) over every row at once, kept where the slot is
  valid;
* ``apply_on_neighbors``: the user's function vmapped over the rows.

The user's function is written with torch ops on one key's values, as the
JAX package's is with ``jnp``; it is user code and has no kernel.  Each
aggregation has a host mode that runs plain Python per vertex.

Direction semantics match slice(): OUT keys by source, IN by target, ALL
keys both endpoints of each edge (SimpleEdgeStream.java:149-163).  With
``cfg.async_windows`` (or ``GELLY_ASYNC_WINDOWS``) > 0 the aggregations run
on the asynchronous window pipeline (``_kernel_chunks_async``).  The mesh
path (``cfg.num_shards`` > 1 with that many GPUs) is not ported: it raises
``NotImplementedError``.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.core import async_exec
from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.core.types import EdgeDirection, _tree_unflatten_like, tree_leaves, tree_map
from gelly_streaming_tpu_torch.core.windows import WindowPane, pad_pane_edges, pad_rows, validate_slide, windowed_panes
from gelly_streaming_tpu_torch.ops import neighborhoods as nbh_ops
from gelly_streaming_tpu_torch.utils import metrics

_NEEDS_VALUES_MSG = "this aggregation requires edge values; the stream has none"
_MESH_MSG = (
    "the sharded snapshot plane (cfg.num_shards > 1 with that many GPUs) is not "
    "ported yet (ROADMAP queue A, item 8)"
)

# Python scalars in a fold's initial accumulator take the JAX package's
# default (32-bit) dtypes
_SCALAR_DTYPES = ((bool, torch.bool), (int, torch.int32), (float, torch.float32))


class Neighborhoods:
    """One degree bucket of a closed pane: [num_keys, D] tensors on the
    stream's device (rows in sorted key order, neighbors in arrival order,
    columns past a key's degree invalid)."""

    def __init__(self, pane: WindowPane, keys, nbrs, vals, valid, num_keys):
        self.pane = pane
        self.keys = keys  # [num_keys]
        self.nbrs = nbrs  # [num_keys, D]
        self.vals = vals  # None or value tree of [num_keys, D]
        self.valid = valid  # [num_keys, D] bool
        self.num_keys = num_keys


def _init_leaf(x, rows: int, device: torch.device) -> torch.Tensor:
    """One leaf of a fold's initial accumulator, broadcast to every row."""
    if not isinstance(x, torch.Tensor):
        dtype = next((d for t, d in _SCALAR_DTYPES if isinstance(x, t)), None)
        x = torch.as_tensor(x, dtype=dtype)
    x = x.to(device)
    return x.expand((rows,) + tuple(x.shape)).clone()


def _where_rows(ok: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(ok[row], a[row], b[row])`` for leaves of any rank."""
    return torch.where(ok.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _host_records(out, n: int):
    """The first ``n`` records of a host output tree, one Python value tree
    each."""
    leaves = tree_leaves(out)
    for i in range(n):
        yield _tree_unflatten_like(out, [leaf[i].item() for leaf in leaves])


class SnapshotStream:
    """Windowed graph-snapshot stream (reference: SnapshotStream.java:46)."""

    def __init__(
        self,
        edge_stream,
        window_ms: int,
        direction: EdgeDirection,
        slide_ms: Optional[int] = None,
    ):
        self._stream = edge_stream
        self.window_ms = window_ms
        self.direction = direction
        validate_slide(window_ms, slide_ms)
        self.slide_ms = slide_ms

    def _panes(self):
        """Closed window panes: tumbling, or pane-shared sliding windows when
        ``slide_ms`` divides the window (core/windows.sliding_panes)."""
        return windowed_panes(self._stream, self.window_ms, self.slide_ms)

    def _directed_edges(self, pane: WindowPane):
        """(src, dst, val) with slice()'s direction semantics applied."""
        src, dst, val = pane.src, pane.dst, pane.val
        if self.direction == EdgeDirection.IN:
            src, dst = dst, src
        elif self.direction == EdgeDirection.ALL:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if val is not None:
                val = tree_map(lambda a: np.concatenate([a, a]), val)
        return src, dst, val

    def _padded_pane_edges(self, pane: WindowPane):
        """Direction semantics + the pow2 pad of one pane's edges: numpy
        ``(src, dst, val | None, mask)``, or None for an edge-less pane.
        Arrays that are int32 and already of the padded length are used as
        they are, not copied."""
        src, dst, val = self._directed_edges(pane)
        if len(src) == 0:
            return None
        src_p, dst_p, mask = pad_pane_edges(pane._replace(src=src, dst=dst, val=None))
        return src_p, dst_p, tree_map(lambda a: pad_rows(a, len(mask)), val), mask

    def _neighborhood_panes(self) -> Iterator[Neighborhoods]:
        """Degree-bucketed neighborhoods per closed pane, built on the
        stream's device; buckets with no keys are skipped."""
        dev = self._stream.device
        for pane in self._panes():
            padded = self._padded_pane_edges(pane)
            if padded is None:
                continue
            src_p, dst_p, val_p, mask = padded
            buckets = nbh_ops.build_buckets(
                torch.from_numpy(src_p).to(dev),
                torch.from_numpy(dst_p).to(dev),
                tree_map(lambda a: torch.from_numpy(a).to(dev), val_p),
                torch.from_numpy(mask).to(dev),
            )
            for bkt in buckets:
                if bkt.num_keys == 0:
                    continue
                yield Neighborhoods(pane, bkt.keys, bkt.nbrs, bkt.vals, bkt.valid, bkt.num_keys)

    # ---- kernel execution ---------------------------------------------------

    def _use_mesh(self) -> bool:
        cfg = self._stream.cfg
        return 1 < cfg.num_shards <= torch.cuda.device_count()

    def _kernel_chunks(self, bucket_kernel, needs_vals: bool):
        """Run ``bucket_kernel(keys, nbrs, vals, valid)`` over every
        neighborhood bucket; yield host chunks ``(window_id, keys [n], out
        tree of [n, ...], n)`` of real rows."""
        if self._use_mesh():
            raise NotImplementedError(_MESH_MSG)
        depth = async_exec.resolve_depth(self._stream.cfg)
        if depth > 0:
            yield from self._kernel_chunks_async(bucket_kernel, needs_vals, depth)
            return
        for hood in self._neighborhood_panes():
            if needs_vals and hood.vals is None:
                raise ValueError(_NEEDS_VALUES_MSG)
            out = bucket_kernel(hood.keys, hood.nbrs, hood.vals, hood.valid)
            n = hood.num_keys
            yield (
                hood.pane.window_id,
                hood.keys.cpu().numpy()[:n],
                tree_map(lambda a: a.cpu().numpy()[:n], out),
                n,
            )

    def _kernel_chunks_async(self, bucket_kernel, needs_vals: bool, depth: int):
        """``_kernel_chunks`` on the asynchronous window pipeline: direction
        and pow2 padding on the pack thread, the upload on the transfer
        thread, the bucket build and kernels dispatched here with their
        outputs' copies to pinned host memory started, the real rows cut at
        the completion-queue drain.  The chunk sequence (window order,
        bucket order) is the synchronous path's.

        ``build_buckets`` reads its bucket counts back to the host, so each
        build blocks this thread until the device has run the pane's sort
        and count; that wait is counted as dispatch stall (and apart, as
        ``pipeline_dispatch_build_s``)."""
        dev = self._stream.device

        def prepare(pane: WindowPane):
            padded = self._padded_pane_edges(pane)
            if padded is None:
                return (pane.window_id, None), None
            src, dst, val, mask = padded
            return (pane.window_id, val), (src, dst, mask, *tree_leaves(val))

        def dispatch(meta, arrays):
            if arrays is None:
                return None
            src, dst, mask, *leaves = arrays
            val = None if meta[1] is None else _tree_unflatten_like(meta[1], leaves)
            if needs_vals and val is None:
                raise ValueError(_NEEDS_VALUES_MSG)
            t0 = time.perf_counter()
            buckets = nbh_ops.build_buckets(src, dst, val, mask)
            waited = time.perf_counter() - t0
            metrics.pipeline_add("pipeline_dispatch_stall_s", waited)
            metrics.pipeline_add("pipeline_dispatch_build_s", waited)
            handles = []
            for bkt in buckets:
                if bkt.num_keys == 0:
                    continue
                out = bucket_kernel(bkt.keys, bkt.nbrs, bkt.vals, bkt.valid)
                handles.append((bkt.num_keys, async_exec.start_host_fetch((bkt.keys, out))))
            return handles

        def finish(meta, handles):
            chunks = []
            for n, fetch in handles or ():
                keys, out = async_exec.wait_ready(fetch)
                chunks.append((meta[0], keys.numpy()[:n], tree_map(lambda a: a.numpy()[:n], out), n))
            return chunks

        for chunks in async_exec.pipelined(self._panes(), prepare, dispatch, finish, depth, dev):
            yield from chunks

    # ---- aggregations -------------------------------------------------------

    def fold_neighbors(self, init_accum, fold_fn: Callable, mode: str = "device") -> OutputStream:
        """Per key, fold neighbors in arrival order:
        ``fold_fn(accum, vid, nbr_id, edge_value) -> accum`` (reference
        EdgesFoldFunction, SnapshotStream.java:61-86).  Emits the final
        accumulator per (vertex, window).

        ``mode="host"`` runs ``fold_fn`` as plain Python per neighbor;
        ``init_accum`` may then be any Python value."""
        if mode not in ("device", "host"):
            raise ValueError(f"unknown fold_neighbors mode {mode!r}")
        if mode == "host":

            def host_apply(vid, neighbors):
                accum = copy.deepcopy(init_accum)
                for nbr, val in neighbors:
                    accum = fold_fn(accum, vid, nbr, val)
                # a tuple accumulator splats into a multi-field record, as on
                # the device path; anything else (a list too) is one field
                return accum if isinstance(accum, tuple) else (accum,)

            return self._apply_on_neighbors_host(host_apply, None)

        def kernel(keys, nbrs, vals, valid):
            rows, width = nbrs.shape
            step = torch.func.vmap(fold_fn, in_dims=(0, 0, 0, None if vals is None else 0))
            accum = tree_map(lambda leaf: _init_leaf(leaf, rows, keys.device), init_accum)
            for j in range(width):
                new = step(accum, keys, nbrs[:, j], tree_map(lambda a: a[:, j], vals))
                accum = tree_map(lambda n, a: _where_rows(valid[:, j], n, a), new, accum)
            return accum

        def records():
            for _, _keys, out, n in self._kernel_chunks(kernel, False):
                for rec in _host_records(out, n):
                    yield rec if isinstance(rec, tuple) else (rec,)

        return OutputStream(records)

    def reduce_on_edges(self, reduce_fn: Callable, mode: str = "device") -> OutputStream:
        """Per key, reduce edge values pairwise; emits (vertex, reduced)
        (reference EdgesReduceFunction + project(0,2),
        SnapshotStream.java:100-120).  Valueless streams are rejected.

        ``mode="host"`` runs ``reduce_fn`` as plain Python."""
        if mode not in ("device", "host"):
            raise ValueError(f"unknown reduce_on_edges mode {mode!r}")
        if mode == "host":

            def host_apply(vid, neighbors):
                if not neighbors:
                    return None
                if neighbors[0][1] is None:
                    raise ValueError(_NEEDS_VALUES_MSG)
                acc = neighbors[0][1]
                for _, val in neighbors[1:]:
                    acc = reduce_fn(acc, val)
                return (vid, acc)

            return self._apply_on_neighbors_host(host_apply, None)

        def kernel(keys, nbrs, vals, valid):
            rows, width = valid.shape
            step = torch.func.vmap(reduce_fn)
            accum = tree_map(lambda a: torch.zeros_like(a[:, 0]), vals)
            started = torch.zeros((rows,), dtype=torch.bool, device=valid.device)
            for j in range(width):
                ok = valid[:, j]
                val = tree_map(lambda a: a[:, j], vals)
                reduced = step(accum, val)
                accum = tree_map(
                    lambda r, v, a: _where_rows(ok & started, r, _where_rows(ok, v, a)), reduced, val, accum
                )
                started = started | ok
            return accum

        def records():
            for _, keys_h, out, n in self._kernel_chunks(kernel, True):
                for i, rec in enumerate(_host_records(out, n)):
                    yield (int(keys_h[i]), rec)

        return OutputStream(records)

    def apply_on_neighbors(
        self,
        apply_fn: Callable,
        post: Optional[Callable] = None,
        mode: str = "device",
    ) -> OutputStream:
        """Per key, run a whole-neighborhood function (reference
        SnapshotFunction wrapping EdgesApply, SnapshotStream.java:129-181).

        ``mode="device"``: ``apply_fn(vid, nbr_ids [D], vals [D], valid [D])
        -> record tree`` of torch ops, vmapped over the bucket's rows;
        ``post`` maps the host record before emission.

        ``mode="host"``: ``apply_fn(vid, neighbors)`` runs as plain Python
        per vertex, ``neighbors`` a list of ``(nbr_id, val)`` tuples (``val``
        None on value-less streams) in neighborhood order; it may return one
        record or a list of records (emit 0..n)."""
        if mode not in ("device", "host"):
            raise ValueError(f"unknown apply_on_neighbors mode {mode!r}")
        if mode == "host":
            return self._apply_on_neighbors_host(apply_fn, post)

        def kernel(keys, nbrs, vals, valid):
            return torch.func.vmap(apply_fn, in_dims=(0, 0, None if vals is None else 0, 0))(keys, nbrs, vals, valid)

        def records():
            for _, _keys, out, n in self._kernel_chunks(kernel, False):
                for rec in _host_records(out, n):
                    if post is not None:
                        rec = post(rec)
                    yield rec if isinstance(rec, tuple) else (rec,)

        return OutputStream(records)

    def _apply_on_neighbors_host(self, apply_fn: Callable, post: Optional[Callable]) -> OutputStream:
        """Host-mode neighborhood apply: arbitrary Python per vertex."""

        def records():
            for hood in self._neighborhood_panes():
                keys = hood.keys.cpu().numpy()
                nbrs = hood.nbrs.cpu().numpy()
                valid = hood.valid.cpu().numpy()
                vals = tree_map(lambda a: a.cpu().numpy(), hood.vals)
                leaves = tree_leaves(vals)
                for i in range(hood.num_keys):
                    sel = valid[i]
                    row = nbrs[i][sel]
                    if vals is None:
                        neighbors = [(int(nb), None) for nb in row]
                    else:
                        # mask each leaf once per vertex, not per neighbor
                        masked = [leaf[i][sel] for leaf in leaves]
                        neighbors = [
                            (int(nb), _tree_unflatten_like(vals, [m[j].item() for m in masked]))
                            for j, nb in enumerate(row)
                        ]
                    out = apply_fn(int(keys[i]), neighbors)
                    if out is None:
                        continue
                    for rec in out if isinstance(out, list) else [out]:
                        if post is not None:
                            rec = post(rec)
                        yield rec if isinstance(rec, tuple) else (rec,)

        return OutputStream(records)
