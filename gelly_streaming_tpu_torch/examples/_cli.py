"""Shared CLI plumbing for the port's example programs (port of
``gelly_streaming_tpu/examples/_cli.py``).

Same contract: ``<program> [input-path output-path ...knobs]`` with a
built-in default dataset when run bare, ``--name=value`` flags, and the
reference's CSV rendering.  The port's examples also take
``--device=cuda|cpu`` (default cuda).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.device import DeviceLike
from gelly_streaming_tpu_torch.io.sources import file_stream, generated_stream

DEFAULT_CFG = StreamConfig(vertex_capacity=1 << 16, max_degree=256, batch_size=1 << 12)


def extract_flags(argv, usage: str, allowed):
    """Split ``--name[=value]`` tokens from positionals: returns
    ``(positionals, {name: value-str-or-True})``; an unrecognized ``--``
    token prints the usage line and exits 2."""
    args = list(sys.argv[1:] if argv is None else argv)
    flags = {}
    rest = []
    for a in args:
        if a.startswith("--"):
            name, _, value = a[2:].partition("=")
            if name not in allowed:
                print(usage, file=sys.stderr)
                raise SystemExit(2)
            flags[name] = value if value else True
        else:
            rest.append(a)
    return rest, flags


def flag_value(flags, name: str, usage: str):
    """Value of --name=VALUE, None if absent; a bare --name prints usage
    and exits 2."""
    v = flags.get(name)
    if v is True:
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    return v


def parse_argv(
    argv: Optional[List[str]], usage: str, max_positional: int
) -> List[str]:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) > max_positional:
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    if not args:
        print("Executing example with default parameters and built-in default data.")
        print(f"  Provide parameters to read input data from a file.\n  Usage: {usage}")
    return args


def input_stream(
    args: List[str],
    cfg: StreamConfig = DEFAULT_CFG,
    generated_edges: int = 1000,
    device: DeviceLike = None,
) -> Tuple[EdgeStream, Optional[str]]:
    """(stream, output_path) from positional [input [output ...]] args."""
    if args:
        stream, _ = file_stream(args[0], cfg, device=device)
    else:
        stream = generated_stream(cfg, generated_edges, num_vertices=100, device=device)
    output = args[1] if len(args) > 1 else None
    return stream, output


def emit(out: OutputStream, output_path: Optional[str]) -> None:
    if output_path:
        out.write_csv(output_path)
    else:
        out.print()
