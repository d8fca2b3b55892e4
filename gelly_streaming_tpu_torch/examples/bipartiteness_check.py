"""Bipartiteness check example
(reference: example/BipartitenessCheckExample.java:38-124, window 500 ms).

Usage: bipartiteness_check [--device=cuda|cpu] [input-path [output-path [window-ms]]]
Emits the running Candidates summary, ``(true,{component={vertex=(vertex,
side), ...}, ...})`` or ``(false,{})``, per merge window.  Runs on the GPU
unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.bipartiteness_check edges.txt out.csv
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import (
    emit,
    extract_flags,
    flag_value,
    input_stream,
    parse_argv,
)
from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck

USAGE = "bipartiteness_check [--device=cuda|cpu] [input-path [output-path [window-ms]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    window_ms = int(args[2]) if len(args) > 2 else 500
    stream, output = input_stream(args, device=device)
    emit(stream.aggregate(BipartitenessCheck(window_ms)), output)


if __name__ == "__main__":
    main()
