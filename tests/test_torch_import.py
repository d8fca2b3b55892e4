"""The PyTorch port stands alone: it imports neither jax, optax nor the JAX package,
its CUDA entry points match their ctypes declarations, and chip_smoke.py
refuses to report a result without a GPU."""

import ast
import os
import re
import subprocess
import sys

import pytest

# subprocess tests
pytestmark = pytest.mark.timeout_cap(120)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gelly_streaming_tpu_torch")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gelly_streaming_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gelly_streaming_tpu_torch.io.sources import NetworkEdgeSource, PushOutOfSync, SourceQuiesced\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'gelly_streaming_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 61, mods\n"
        "for m in ('ops.degrees', 'library.degree_distribution', 'library.bipartiteness',\n"
        "          'summaries.candidates', 'examples.degree_distribution',\n"
        "          'examples.bipartiteness_check', 'ops.neighborhoods', 'ops.sage',\n"
        "          'core.snapshot', 'library.graphsage', 'core.async_exec', 'ops.csr_triangles',\n"
        "          'utils.envswitch', 'ops.spmv', 'library.sssp', 'library.pagerank', 'library.kcore',\n"
        "          'library.iterative_cc', 'examples.sssp', 'examples.pagerank',\n"
        "          'examples.iterative_connected_components', 'utils.value_types', 'utils.threefry',\n"
        "          'summaries.adjacency', 'ops.spanner', 'ops.matching', 'ops.sampled_triangles',\n"
        "          'library.spanner', 'library.matching', 'library.sampled_triangles', 'examples.spanner',\n"
        "          'examples.centralized_weighted_matching', 'examples.broadcast_triangle_count',\n"
        "          'examples.incidence_sampling_triangle_count', 'ops.sketches', 'summaries.sketches',\n"
        "          'library.sketches', 'ops.wire_decode', 'utils.checkpoint', 'utils.recovery',\n"
        "          'utils.native', 'io.ingest', 'utils.tracing', 'utils.ingest_bench',\n"
        "          'examples.measurements'):\n"
        "    assert p.__name__ + '.' + m in mods, m\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=100
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=os.path.basename)
def test_port_source_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "gelly_streaming_tpu"), (path, name)


def test_cuda_entry_points_match_their_ctypes_declarations():
    from gelly_streaming_tpu_torch.ops import _cuda

    for source, entries in _cuda.SIGNATURES.items():
        with open(os.path.join(_cuda.CSRC_DIR, source)) as f:
            text = f.read()
        extern = text[text.index('extern "C" {') :]
        found = dict(re.findall(r"^(?:int|long long) (\w+)\(([^)]*)\)", extern, re.M | re.S))
        assert set(found) == set(entries), source
        for name, argtypes in entries.items():
            assert len(found[name].split(",")) == len(argtypes), name


def test_host_entry_points_match_their_ctypes_declarations():
    """The host C and C++ sources (csrc/*.c with cc, csrc/*.cpp with c++):
    every exported function declared, with as many arguments (a C++
    source's exports: its extern "C" blocks, anonymous namespaces left
    out)."""
    from gelly_streaming_tpu_torch.ops import _cuda

    sources = sorted(f for f in os.listdir(_cuda.CSRC_DIR) if f.endswith((".c", ".cpp")))
    assert sources == sorted(_cuda.HOST_SIGNATURES)
    for source, entries in _cuda.HOST_SIGNATURES.items():
        with open(os.path.join(_cuda.CSRC_DIR, source)) as f:
            text = f.read()
        if source.endswith(".cpp"):
            blocks = re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"', text, re.M | re.S)
            text = re.sub(r"^namespace \{\n.*?^\}  // namespace", "", "\n".join(blocks), flags=re.M | re.S)
        found = dict(re.findall(r"^(?:void|int|long long|int64_t|int32_t) (\w+)\(([^)]*)\)", text, re.M | re.S))
        assert set(found) == set(entries), source
        for name, (argtypes, _restype) in entries.items():
            assert len(found[name].split(",")) == len(argtypes), name


def test_chip_smoke_defines_each_top_level_name_once():
    """A second ``def`` of a name would silently replace the first for
    every phase that calls it."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert len(names) == len(set(names)), sorted({n for n in names if names.count(n) > 1})


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True, text=True, timeout=100
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package beside it
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(lone)], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=100
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
