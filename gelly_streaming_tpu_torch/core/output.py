"""Record output streams and sinks.

The reference's property streams are Flink ``DataStream``s written with
``writeAsCsv`` or collected in test sinks (e.g. TestGetDegrees.java:54-56,
ConnectedComponentsTest.java:84-94).  Here a terminal op yields per-batch record
blocks (dict of equal-length host arrays + validity mask); ``OutputStream``
wraps that iterator with collect/CSV sinks using the same rendering the golden
files assert (Flink Tuple CSV: ``1,2,12``; NullValue -> ``(null)``; nested
tuples -> ``(12,13)``).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np


class NullValue:
    """Singleton mirroring Flink's NullValue; renders as ``(null)`` in CSV."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "(null)"


NULL = NullValue()


def _render(x) -> str:
    if isinstance(x, NullValue):
        return "(null)"
    if isinstance(x, tuple):
        return "(" + ",".join(_render(v) for v in x) + ")"
    if isinstance(x, (bool, np.bool_)):
        return "true" if x else "false"
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    return str(x)


class RecordBlock:
    """A vectorized block of records: one column per record field.

    Columns are equal-length host numpy arrays, or plain Python constants
    (e.g. ``NULL``) broadcast to every row — so a terminal op can emit a whole
    micro-batch's results as arrays without a per-record Python loop.
    """

    __slots__ = ("columns", "num_records")

    def __init__(self, columns: tuple):
        self.columns = columns
        self.num_records = next(
            (len(c) for c in columns if isinstance(c, np.ndarray)), 0
        )

    def tuples(self) -> Iterator[tuple]:
        """Per-record view (the goldens' trace mode)."""
        cols = [
            c if isinstance(c, np.ndarray) else None for c in self.columns
        ]

        def host(x):
            return x.item() if isinstance(x, np.generic) else x

        for i in range(self.num_records):
            yield tuple(
                host(c[i]) if c is not None else const
                for c, const in zip(cols, self.columns)
            )


class OutputStream:
    """A continuous stream of records produced by a terminal operation.

    ``records_fn`` is a zero-arg callable returning an iterator of host tuples
    (so the stream can be re-run, mirroring a dataflow's lazy execution).
    Block-native ops pass ``blocks_fn`` instead — an iterator of RecordBlocks —
    and per-record iteration becomes a derived view: ``blocks()`` is then the
    production sink path (no per-record Python loop), while golden-trace tests
    keep consuming tuples.
    """

    def __init__(
        self,
        records_fn: Optional[Callable[[], Iterator[tuple]]] = None,
        blocks_fn: Optional[Callable[[], Iterator[RecordBlock]]] = None,
    ):
        if (records_fn is None) == (blocks_fn is None):
            raise ValueError("pass exactly one of records_fn / blocks_fn")
        self._records_fn = records_fn
        self._blocks_fn = blocks_fn

    def blocks(self) -> Iterator[RecordBlock]:
        """Vectorized record blocks (production sinks).

        Record-based ops are adapted by chunking tuples into object columns —
        correct but not faster; block-native ops yield their arrays directly.
        """
        if self._blocks_fn is not None:
            return self._blocks_fn()

        def adapt():
            chunk: List[tuple] = []
            for rec in self._records_fn():
                chunk.append(rec)
                if len(chunk) >= 4096:
                    yield RecordBlock(
                        tuple(np.array(c, object) for c in zip(*chunk))
                    )
                    chunk = []
            if chunk:
                yield RecordBlock(
                    tuple(np.array(c, object) for c in zip(*chunk))
                )

        return adapt()

    def __iter__(self) -> Iterator[tuple]:
        if self._records_fn is not None:
            return self._records_fn()

        def derive():
            for blk in self._blocks_fn():
                yield from blk.tuples()

        return derive()

    def collect(self) -> List[tuple]:
        return list(iter(self))

    def collect_last(self) -> Optional[tuple]:
        last = None
        for r in self:
            last = r
        return last

    def lines(self) -> List[str]:
        """CSV lines in the reference's writeAsCsv rendering."""
        return [",".join(_render(f) for f in rec) for rec in self]

    def write_csv(self, path: str) -> None:
        """CSV sink in the reference's writeAsCsv rendering.

        Flat integer/bool column blocks render vectorized (numpy string
        ops — no per-record Python, matching the block emission design of
        the heavy property traces); floats, objects, and constants fall back
        to the per-record renderer, whose formatting is the golden contract.
        """
        with open(path, "w") as f:
            for blk in self.blocks():
                cols = blk.columns
                fast = blk.num_records > 0 and all(
                    isinstance(c, np.ndarray)
                    and c.ndim == 1
                    and (c.dtype == bool or np.issubdtype(c.dtype, np.integer))
                    for c in cols
                )
                if fast:
                    parts = [
                        np.where(c, "true", "false")
                        if c.dtype == bool
                        else c.astype(str)
                        for c in cols
                    ]
                    lines = parts[0]
                    for p in parts[1:]:
                        lines = np.char.add(np.char.add(lines, ","), p)
                    f.write("\n".join(lines.tolist()) + "\n")
                else:
                    for rec in blk.tuples():
                        f.write(",".join(_render(fld) for fld in rec) + "\n")

    def print(self) -> None:
        for rec in self:
            print(",".join(_render(f) for f in rec))
