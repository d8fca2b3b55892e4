"""Port parity: the measurement programs of the PyTorch port against the JAX
package's.

Each mode runs at tests/test_measurements.py's sizes, the port on
``--device=cpu``.  The JSON keys must equal the JAX program's, and every
deterministic field (edge and window counts, degree totals, the bipartite
verdict, triangle, spanner and matching counts, the encoding's bytes an
edge, PageRank's iterations) must equal the JAX run's with the same
arguments.  Rates, latencies, the measured spanner winner and the GraphSAGE
losses are not compared: the port draws its GraphSAGE parameters from a
torch.Generator.  Tolerance: none.
"""

import json
import re

import pytest
import torch

from gelly_streaming_tpu.examples import measurements as jm
from gelly_streaming_tpu_torch.examples import measurements as tm
from gelly_streaming_tpu_torch.ops import wire_decode as wd

CASES = {
    "degrees": ["degrees", "--edges", "4096", "--vertices", "512", "--batch", "512"],
    "degrees_small": ["degrees", "--edges", "100", "--vertices", "64", "--batch", "512"],
    "degrees_trace": ["degrees", "--edges", "4096", "--vertices", "512", "--batch", "1024", "--trace"],
    "bipartiteness": ["bipartiteness", "--edges", "4096", "--vertices", "64", "--batch", "512"],
    "triangles": ["triangles", "--edges", "2048", "--windows", "2", "--pane-vertices", "128"],
    "matching": ["matching", "--edges", "512", "--vertices", "128", "--batch", "128"],
    "spanner": ["spanner", "--edges", "2048", "--vertices", "64", "--batch", "512"],
    "spanner_both": ["spanner", "--edges", "2048", "--vertices", "128", "--batch", "512", "--max-degree", "16",
                     "--k", "3", "--body", "both"],
    "sage": ["sage", "--edges", "2048", "--vertices", "256", "--windows", "2", "--features", "32",
             "--out-features", "16", "--max-degree", "8", "--train-steps", "2"],
    "replay": ["replay", "--edges", "4096", "--vertices", "512", "--batch", "1024"],
    "pagerank": ["pagerank", "--edges", "2048", "--vertices", "256", "--windows", "2"],
    "sssp": ["sssp", "--edges", "1024", "--vertices", "128", "--windows", "2"],
    "kcore": ["kcore", "--edges", "1024", "--vertices", "128", "--windows", "2"],
}

# measured, not computed: rates, latencies, wall times, the timing-picked
# spanner winner, and the losses of differently drawn parameters
_MEASURED = re.compile(r"per_sec|eps$|_ms$|_ms_|gbps|runtime|loss|winner|crossover")


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX run a case, shared by the tests of this module."""
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _jax(CASES[case])
        return runs[case]

    return get


def _jax(argv):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jm.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES)
def test_mode_matches_jax(case, jax_runs):
    want = jax_runs(case)
    got = tm.run(CASES[case] + ["--device=cpu"])
    assert list(got) == list(want)
    fixed = {k: v for k, v in want.items() if not _MEASURED.search(k)}
    assert {k: got[k] for k in fixed} == fixed
    assert all(got[k] > 0 for k in got if k.endswith("per_sec") or k.endswith("_eps"))


def test_mode_contracts_on_the_port():
    """tests/test_measurements.py's contracts, held on the port's runs."""
    deg = tm.run(CASES["degrees_trace"] + ["--device=cpu"])
    assert deg["degree_total"] == 2 * deg["edges_folded"] == 2 * 4096
    assert deg["trace_records"] == 2 * 4096 and deg["flink_proxy_counts_ok"] is True
    assert tm.run(CASES["bipartiteness"] + ["--device=cpu"])["bipartite"] is False
    assert tm.run(CASES["replay"] + ["--device=cpu"])["bytes_per_edge"] < 3  # EF40 over width 2


def test_wire_folds_unpack_once_a_batch():
    """degrees and bipartiteness unpack each wire batch through
    ``unpack_edges_fixed`` (its twin on the CPU): the warm-up and the
    metered batches, once each."""
    for mode in ("degrees", "bipartiteness"):
        wd.reset_launches()
        tm.run([mode, "--edges", "4096", "--vertices", str(1 << 17), "--batch", "512", "--device=cpu"])
        assert wd.TWIN_CALLS["wire_unpack"] == 4096 // 512  # PAIR40 at 2^17 vertices
    wd.reset_launches()
    tm.run(["degrees", "--edges", "4096", "--vertices", str(1 << 17), "--batch", "1024", "--trace", "--device=cpu"])
    # the fold's 4 batches, then two drains of the 4-batch from_wire trace
    assert wd.TWIN_CALLS["wire_unpack"] == 4 + 2 * 4


def test_main_prints_one_json_line(capsys):
    tm.main(CASES["sssp"] + ["--device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["workload"] == "sssp"


def test_requires_subcommand():
    with pytest.raises(SystemExit):
        tm.main([])


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.run(CASES["sssp"])


def test_routing_is_not_faked():
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        tm.run(["routing", "--device=cpu"])
