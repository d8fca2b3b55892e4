"""Loader for the port's native host ingest library.

Port of ``gelly_streaming_tpu/utils/native.py``.  ``csrc/edge_parser.cpp``
(the JAX package's C++ edge parser cut to the ingest exports) is compiled
by ``ops/_cuda.host_library`` with the host C++ compiler into the
git-ignored build directory at first use and loaded with ctypes, whose
calls release the GIL, so the ingest pool's workers overlap.  The
signature table is ``_cuda.HOST_SIGNATURES["edge_parser.cpp"]``.  Without
a compiler ``load_ingest_lib`` returns None and every caller keeps its
numpy path, which gives the same bytes.

Every call through the loaded library adds one to ``CALLS[name]``, so a
run can show that its hot path went through the native code.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from gelly_streaming_tpu_torch.ops import _cuda

SOURCE = "edge_parser.cpp"

_lock = threading.Lock()
_lib = None
_tried = False
# native calls since the last reset_calls(), by export
CALLS: Dict[str, int] = {name: 0 for name in _cuda.HOST_SIGNATURES[SOURCE]}


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


class IngestLib:
    """The loaded library's exports, each counting its calls."""

    def __init__(self, cdll):
        self.cdll = cdll
        for name in _cuda.HOST_SIGNATURES[SOURCE]:
            setattr(self, name, self._counted(name, getattr(cdll, name)))

    @staticmethod
    def _counted(name: str, fn):
        def call(*args):
            with _lock:
                CALLS[name] += 1
            return fn(*args)

        call.__name__ = name
        return call


def load_ingest_lib() -> Optional[IngestLib]:
    """The compiled ingest library, or None when it cannot be built here
    (the first failure is remembered)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            lib = IngestLib(_cuda.host_library(SOURCE))
        except (RuntimeError, OSError):
            lib = None
        _lib = lib
        _tried = True
        return _lib
