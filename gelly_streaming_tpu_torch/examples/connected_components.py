"""Streaming Connected Components example
(reference: example/ConnectedComponentsExample.java:40-168).

Usage: connected_components [--device=cuda|cpu] [input-path [output-path
                            [window-ms [--tree] [--unbounded[=BATCHES]]
                            [--ingest-window=EDGES]]]]
Emits the running component sets (flattened DisjointSet) per merge window,
one ``root,members`` row a component.  ``--unbounded`` replaces the input
with an endless untimed generated stream and ``--ingest-window=EDGES``
cuts a pane every EDGES arrivals (default 4096 with ``--unbounded``);
``--unbounded=BATCHES`` bounds that stream.  Runs on the GPU unless
``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.connected_components edges.txt out.csv
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import (
    DEFAULT_CFG,
    emit,
    extract_flags,
    flag_value,
    input_stream,
    parse_argv,
)
from gelly_streaming_tpu_torch.io.sources import unbounded_generated_stream
from gelly_streaming_tpu_torch.library.connected_components import (
    ConnectedComponents,
    ConnectedComponentsTree,
)

USAGE = (
    "connected_components [--device=cuda|cpu] [input-path [output-path [window-ms "
    "[--tree] [--unbounded[=BATCHES]] [--ingest-window=EDGES]]]]"
)


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("tree", "unbounded", "ingest-window", "device"))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    unbounded = flags.get("unbounded")
    ingest = flags.get("ingest-window")
    window_ms = int(args[2]) if len(args) > 2 else 1000
    every = int(ingest) if ingest not in (None, True) else None
    output = args[1] if len(args) > 1 else None
    if unbounded is not None:
        cfg = dataclasses.replace(DEFAULT_CFG, ingest_window_edges=every or 4096)
        stream = unbounded_generated_stream(
            cfg,
            num_vertices=100,
            max_batches=int(unbounded) if unbounded is not True else None,
            device=device,
        )
    else:
        cfg = dataclasses.replace(DEFAULT_CFG, ingest_window_edges=every) if every else DEFAULT_CFG
        stream, output = input_stream(args, cfg, device=device)
    algo = (ConnectedComponentsTree if "tree" in flags else ConnectedComponents)(window_ms)
    results = stream.aggregate(algo)

    # flatten each window's summary into component rows (FlattenSet analog,
    # ConnectedComponentsExample.java:143-156)
    def records():
        for (ds,) in results:
            for root, members in sorted(ds.components().items()):
                yield (root, " ".join(str(v) for v in members))

    emit(OutputStream(records), output)


if __name__ == "__main__":
    main()
