"""The sampled triangle estimators' key chain on a host core
(``csrc/threefry_chain.c``) against ``jax.random.split`` on the CPU.

The JAX package splits the samplers' key in three at every step and keeps
the first; the port computes that chain in C ahead of the card
(``ops/sampled_triangles.host_chain``).  Here it is built with ``cc`` and
held against ``jax.random.split`` iterated and against the port's own
``utils/threefry.py``: several seeds, 2^14 steps, chains cut into pieces
of uneven length that continue one another.  Its build is safe when
several processes reach it at once.  Tolerance: none (bits).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch.ops import _cuda
from gelly_streaming_tpu_torch.ops import sampled_triangles as sto
from gelly_streaming_tpu_torch.utils import threefry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 1 << 14
SEEDS = [0, 1, 12345, 0xDEADBEEF, -7, (1 << 31) - 1]


def _jax_chain(seed: int, n: int) -> np.ndarray:
    """uint32 [n + 1, 2]: the key before each of n steps, then after them,
    as the JAX package's step computes it (``split(key, 3)[0]``)."""

    def step(key, _):
        return jax.random.split(key, 3)[0], key

    last, keys = jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=n)
    return np.concatenate([np.asarray(keys), np.asarray(last)[None]]).astype(np.uint32)


def _host(key, n, out=None) -> np.ndarray:
    return sto.host_chain(key, n, out).numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_chain_matches_jax_split(seed):
    got = _host(threefry.seed(seed), STEPS)
    assert got.shape == (STEPS + 1, 2)
    assert np.array_equal(got, _jax_chain(seed, STEPS))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uneven_pieces_continue_the_chain(seed):
    """Pieces of uneven length, each from the key the last one ended on,
    written into one buffer at an offset: the same chain."""
    want = _jax_chain(seed, STEPS)
    buf = torch.zeros((STEPS + 1, 2), dtype=torch.int32)
    rng = np.random.default_rng(seed & 0xFFFF)
    at, key = 0, threefry.seed(seed)
    while at < STEPS:
        n = int(min(STEPS - at, rng.choice([0, 1, 2, 37, 255, 1000, 4097])))
        piece = _host(key, n, buf[at:])
        assert np.array_equal(piece, want[at : at + n + 1])
        key = (int(piece[n, 0]), int(piece[n, 1]))
        at += n
    assert np.array_equal(buf.numpy().view(np.uint32), want)


def test_host_chain_matches_the_ports_threefry():
    key = threefry.seed(99)
    got = _host(key, 2000)
    for t in range(2001):
        assert (int(got[t, 0]), int(got[t, 1])) == key, t
        key = threefry.threefry_2x32(key[0], key[1], 0, 0)


def test_host_chain_checks_its_output():
    with pytest.raises(ValueError):
        sto.host_chain((0, 1), 10, torch.zeros((10, 2), dtype=torch.int32))  # one row short
    with pytest.raises(ValueError):
        sto.host_chain((0, 1), -1)
    assert _host((5, 6), 0).tolist() == [[5, 6]]


def test_key_chain_and_the_cpu_twin_refuse_each_other():
    """A KeyChain feeds CUDA states only; the CPU twin draws its own keys."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library import sampled_triangles as lst

    with pytest.raises(ValueError):
        sto.KeyChain((0, 1), "cpu")
    state = lst.init_samplers(StreamConfig(vertex_capacity=8), 4, device="cpu")
    s = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        sto.sampler_scan(state, s, s, None, chain=object())


@pytest.mark.timeout_cap(120)
def test_host_build_is_safe_under_concurrent_processes(tmp_path):
    """Six processes build the library into one empty directory at once
    (a temporary file each, then an atomic rename); every one loads a
    library that computes the chain."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from gelly_streaming_tpu_torch.ops import _cuda\n"
        "from gelly_streaming_tpu_torch.ops import sampled_triangles as sto\n"
        "_cuda.BUILD_DIR = Path(sys.argv[1])\n"
        "print(sto.host_chain((0, 42), 3)[3].tolist())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    want = _host((0, 42), 3)[3].astype(np.int32).tolist()
    assert all(o.strip() == str(want) for o, _ in outs)
    built = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(built) == 1 and not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert _cuda.HOST_SIGNATURES["threefry_chain.c"]
