"""The port's kernel wrappers launch on their tensors' device.

A C entry point acts on the current CUDA device (its launch, its
``cudaMemsetAsync``, its occupancy and shared-memory attributes), and a
tensor's default stream handle is 0, the null stream of whichever device
is current.  So a mesh shard on ``cuda:1`` needs ``cuda:1`` current while
its kernels launch.  Every wrapper that reaches a ``*_launch`` entry point
is decorated with ``ops/_cuda.on_device_of`` or calls it inside
``ops/_cuda.device_guard``; these tests hold that over the source and hold
the guard to selecting the argument's device, on the CPU.
"""

import ast
import contextlib
import pathlib
import types

import pytest
import torch

from gelly_streaming_tpu_torch.ops import _cuda
from gelly_streaming_tpu_torch.ops import routing as rk

PKG = pathlib.Path(_cuda.__file__).resolve().parent.parent
ENTRY_POINTS = {name for fns in _cuda.SIGNATURES.values() for name in fns if name.endswith("_launch")}
SOURCES = sorted(p for p in PKG.rglob("*.py") if p.name != "_cuda.py")


def _is_cuda_helper(node, name: str) -> bool:
    """``node`` is ``_cuda.<name>(...)``."""
    f = node.func if isinstance(node, ast.Call) else None
    return isinstance(f, ast.Attribute) and f.attr == name and isinstance(f.value, ast.Name) and f.value.id == "_cuda"


def _unguarded_entry_points(fn: ast.FunctionDef):
    """The entry points ``fn`` names outside a ``with _cuda.device_guard``
    block (nested functions are checked on their own)."""
    found = []

    def visit(node, guarded: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            inner = guarded
            if isinstance(child, ast.With) and any(_is_cuda_helper(i.context_expr, "device_guard") for i in child.items):
                inner = True
            if isinstance(child, ast.Attribute) and child.attr in ENTRY_POINTS and not inner:
                found.append((child.attr, child.lineno))
            visit(child, inner)

    visit(fn, False)
    return found


def _launching_functions():
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                names = [n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute) and n.attr in ENTRY_POINTS]
                if names:
                    yield path, fn


LAUNCHING = list(_launching_functions())


def test_the_walk_finds_the_wrappers():
    names = {fn.name for _, fn in LAUNCHING}
    assert {"owner_pack", "block_delta_fold", "slab_fold", "_launch", "degree_fold", "unpack_edges_ef40",
            "unpack_edges_fixed", "decode_bdv"} <= names


@pytest.mark.parametrize("path,fn", LAUNCHING, ids=[f"{p.stem}.{f.name}" for p, f in LAUNCHING])
def test_every_launch_runs_on_its_tensors_device(path, fn):
    decorated = [d for d in fn.decorator_list if _is_cuda_helper(d, "on_device_of")]
    if decorated:
        (arg,) = [a.value for a in decorated[0].args]
        params = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        assert arg in params, f"{path.name}:{fn.name} guards on {arg!r}, not one of its parameters"
        return
    assert not _unguarded_entry_points(fn), f"{path.name}:{fn.name} launches outside a device guard"


class _Recorder:
    """A stand-in for ``torch.cuda.device`` that records the devices made
    current, and which one is current."""

    def __init__(self):
        self.entered, self.current = [], None

    def __call__(self, dev):
        @contextlib.contextmanager
        def ctx():
            prev, self.current = self.current, dev
            self.entered.append(dev)
            try:
                yield
            finally:
                self.current = prev

        return ctx()


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "device", rec)
    return rec


@pytest.mark.parametrize("index", [0, 1, 3])
def test_device_guard_makes_the_argument_device_current(recorder, index):
    dev = torch.device("cuda", index)
    with _cuda.device_guard(types.SimpleNamespace(device=dev)):
        assert recorder.current == dev
    with _cuda.device_guard(dev):
        assert recorder.current == dev
    assert recorder.current is None and recorder.entered == [dev, dev]


def test_device_guard_leaves_cpu_arguments_alone(recorder):
    with _cuda.device_guard(torch.zeros(3)):
        pass
    with _cuda.device_guard(torch.device("cpu")):
        pass
    with _cuda.device_guard(None):
        pass
    assert recorder.entered == []


@pytest.mark.parametrize("by_keyword", [False, True])
def test_on_device_of_selects_the_named_argument(recorder, by_keyword):
    seen = []

    @_cuda.on_device_of("block")
    def wrapper(other, block, flag=None):
        seen.append(recorder.current)
        return block

    home, shard = torch.device("cuda", 0), torch.device("cuda", 2)
    args = (types.SimpleNamespace(device=home),)
    block = types.SimpleNamespace(device=shard)
    out = wrapper(*args, block=block) if by_keyword else wrapper(*args, block)
    assert out is block and seen == [shard] and recorder.current is None
    assert wrapper.__name__ == "wrapper"


def test_a_decorated_wrapper_on_cpu_tensors_runs_its_twin(recorder):
    block = torch.tensor([5, 1, 7], dtype=torch.int32)
    rk.reset_launches()
    rk.slab_fold(block, [torch.tensor([3, 2, 9], dtype=torch.int32)], "min")
    assert block.tolist() == [3, 1, 7]
    assert recorder.entered == [] and rk.TWIN_CALLS["slab_fold"] == 1 and rk.LAUNCHES["slab_fold"] == 0
