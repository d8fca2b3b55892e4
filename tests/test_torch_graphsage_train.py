"""Port parity: GraphSAGE training (the unsupervised loss, its weight
gradient and the Adam step) of the PyTorch port against the JAX package on
the CPU.

Both packages get the same inputs and the same pairs, made with numpy
(``sample_pairs`` draws JAX's random bits in one package and a
``torch.Generator``'s in the other), and start from the same f32 masters,
carried across by ``interop.sage_train_state_from_numpy``.  Tolerances are
the JAX package's own between its training planes
(tests/test_graphsage.py): the loss within rtol 2e-2, the gradients within
rtol 5e-2, atol 5e-3.  Both round the layer's output and the gradients to
bf16, in different places (the JAX kernel rounds the neighbor sum and
each projection apart; the port makes one product of ``[x_self | mean]``
with ``[W_self; W_nbr]``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gelly_streaming_tpu.library import graphsage as jgs
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.library import graphsage as tgs
from gelly_streaming_tpu_torch.ops import sage

LOSS_RTOL = 2e-2
GRAD_TOL = dict(rtol=5e-2, atol=5e-3)
LR = 1e-2


def _batch(seed, cap, k, d, f, oor=False):
    """(features, keys, nbrs, valid, pos_ids, has_pos, neg_ids) numpy
    arrays: one bucket and its pairs as sample_pairs defines them (a
    uniform valid neighbor, nbrs[:, 0] for an empty row; a uniform
    negative).  ``oor``: ids -1, C and C + 5 among keys and neighbors."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(cap, f)).astype(np.float32)
    ids = np.arange(cap) if not oor else np.concatenate([np.arange(cap), [-1, cap, cap + 5]])
    keys = rng.choice(ids, k).astype(np.int32)
    nbrs = rng.choice(ids, (k, d)).astype(np.int32)
    valid = rng.random((k, d)) < 0.7
    valid[0] = False
    scores = np.where(valid, rng.random((k, d)), -1.0)
    pos = nbrs[np.arange(k), scores.argmax(1)].astype(np.int32)
    has = valid.any(1)
    neg = rng.integers(0, cap, k).astype(np.int32)
    return feats, keys, nbrs, valid, pos, has, neg


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port_state(jstate, lr=LR, moments=False):
    kw = {}
    if moments:
        adam = jstate.opt_state[0]
        kw = dict(mu=[np.asarray(a) for a in adam.mu], nu=[np.asarray(a) for a in adam.nu], count=adam.count)
    return interop.sage_train_state_from_numpy(*(np.asarray(p) for p in jstate.params), lr=lr, device="cpu", **kw)


@pytest.mark.parametrize("seed,cap,k,d,f_in,f_out,oor", [
    (0, 32, 16, 4, 8, 8, False),
    (1, 64, 64, 8, 32, 16, True),
    (2, 40, 24, 40, 16, 24, False),  # rows past 32 slots: the partial-sum path's shape
])
def test_sage_loss_and_grads_match_jax(seed, cap, k, d, f_in, f_out, oor):
    arrays = _batch(seed, cap, k, d, f_in, oor)
    jstate = jgs.sage_init_train(jax.random.key(seed), f_in, f_out, optax.adam(LR))
    jloss, jgrads = jax.jit(jax.value_and_grad(jgs.sage_loss))(jstate.params, *_jax(arrays))
    state = _port_state(jstate)
    loss = tgs.sage_loss(state.params, *_torch(arrays))
    grads = torch.autograd.grad(loss, list(state.params))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.float32 and g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)


@pytest.mark.parametrize("seed,cap,k,f_in,f_out", [(4, 48, 32, 16, 8), (5, 64, 40, 32, 24)])
def test_the_contexts_term_gives_w_nbr_no_gradient_in_both_packages(seed, cap, k, f_in, f_out):
    """The premise of the backward kernel's D = 0 skip: the contexts' term
    alone (the pair terms with z held constant) gives W_nbr a gradient of
    exactly 0 in both packages (JAX's _context never forms it; the port's
    layer over an empty neighborhood multiplies a mean of 0), and the same
    W_self and bias gradients."""
    feats, keys, nbrs, valid, pos, has, neg = _batch(seed, cap, k, 4, f_in)
    z = np.random.default_rng(seed + 100).normal(size=(k, f_out)).astype(np.float32)
    jstate = jgs.sage_init_train(jax.random.key(seed), f_in, f_out, optax.adam(LR))

    def contexts_term(params):
        p, f = jgs._as_bf16(params), jnp.asarray(feats)
        t = jgs._pair_terms(jnp.asarray(z), jgs._context(p, f[pos]), jgs._context(p, f[neg]), jnp.asarray(has))
        return t[0] / jnp.maximum(t[1], 1.0) + t[2] / jnp.maximum(t[3], 1.0)

    jgrads = jax.grad(contexts_term)(jstate.params)
    state = _port_state(jstate)

    def layer(table, ids, nb, vd, w, bias):  # the bucket's z held constant; the contexts by the plain layer
        return torch.from_numpy(z) if nb.shape[1] else sage.sage_layer_plain(table, ids, nb, vd, w, bias)

    loss = tgs._loss(layer, state.params, *_torch((feats, keys, nbrs, valid, pos, has, neg)))
    grads = torch.autograd.grad(loss, list(state.params))
    assert not grads[1].any() and not np.asarray(jgrads.w_nbr).any()
    assert grads[0].abs().max() > 0 and grads[2].abs().max() > 0
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)


def test_train_steps_and_a_resume_from_an_optax_state_match_jax():
    """Five steps from one carried-across state, then a resume: 3 JAX steps,
    the state (masters, Adam's moments and count) carried across, one more
    step in each package.  Adam moves each element by about lr a step
    whatever its gradient's size, so an element whose gradient lies within
    the packages' bf16 roundings of 0 may step the other way: after n
    steps the masters are held within 2 n lr, and all but 2% of the
    elements within lr / 10."""
    arrays = _batch(1, 64, 64, 8, 32, 16)
    tx = optax.adam(LR)
    jstate = jgs.sage_init_train(jax.random.key(1), 32, 16, tx)
    jstep = jax.jit(lambda s: jgs.sage_train_step(tx, s, *_jax(arrays)))
    state, targs = _port_state(jstate), _torch(arrays)
    first = jstate
    for n in range(1, 6):
        jstate, jloss = jstep(jstate)
        state, loss = tgs.sage_train_step(state, *targs)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        diff = np.concatenate([np.abs(p.detach().numpy() - np.asarray(jp)).ravel()
                               for p, jp in zip(state.params, jstate.params)])
        assert diff.max() <= 2 * n * LR and np.mean(diff > LR / 10) <= 0.02, (n, diff.max())
    assert float(loss) < float(tgs.sage_loss(_port_state(first).params, *targs).detach())

    resumed = first
    for _ in range(3):
        resumed, _ = jstep(resumed)
    carried, fresh = _port_state(resumed, moments=True), _port_state(resumed)
    assert int(carried.opt.state[carried.params[0]]["step"]) == 3
    after, jloss = jstep(resumed)
    carried, loss = tgs.sage_train_step(carried, *targs)
    fresh, _ = tgs.sage_train_step(fresh, *targs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    moved_c = moved_f = 0.0
    for pc, pf, jp, j0 in zip(carried.params, fresh.params, after.params, resumed.params):
        jp, j0 = np.asarray(jp), np.asarray(j0)
        np.testing.assert_allclose(pc.detach().numpy(), jp, rtol=0, atol=LR / 4)
        moved_c += float(np.abs(pc.detach().numpy() - jp).sum())
        moved_f += float(np.abs(pf.detach().numpy() - jp).sum())
    assert moved_c < moved_f / 4  # the moments were carried: a fresh Adam steps elsewhere


def test_training_reduces_loss():
    """The JAX package's own bar (tests/test_graphsage.py): the loss falls
    below half its first value within 60 steps, pairs from sample_pairs."""
    feats, keys, nbrs, valid, *_ = _torch(_batch(0, 32, 16, 4, 8))
    state = tgs.sage_init_train(8, 8, lr=3e-2, generator=torch.Generator().manual_seed(0), device="cpu")
    pairs = tgs.sample_pairs(torch.Generator().manual_seed(1), nbrs, valid, feats.shape[0])
    losses = []
    for _ in range(60):
        state, loss = tgs.sage_train_step(state, feats.to(torch.bfloat16), keys, nbrs, valid, *pairs)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert all(bool(torch.isfinite(p).all()) and p.dtype == torch.float32 for p in state.params)


@pytest.mark.parametrize("k,d", [(200, 1), (300, 8), (50, 64)])
def test_sample_pairs_semantics(k, d):
    rng = np.random.default_rng(d)
    cap = 97
    nbrs = torch.from_numpy(rng.integers(0, cap, (k, d)).astype(np.int32))
    valid = torch.from_numpy(rng.random((k, d)) < 0.4)
    valid[:5] = False
    pos, has, neg = tgs.sample_pairs(torch.Generator().manual_seed(k), nbrs, valid, cap)
    assert pos.dtype == neg.dtype == torch.int32 and has.dtype == torch.bool
    assert torch.equal(has, valid.any(1))
    chosen = (nbrs == pos[:, None]) & valid
    assert bool(chosen.any(1)[has].all())  # the positive is a valid neighbor
    assert torch.equal(pos[~has], nbrs[~has, 0])  # an empty row gives its first slot
    assert int(neg.min()) >= 0 and int(neg.max()) < cap
    again = tgs.sample_pairs(torch.Generator().manual_seed(k), nbrs, valid, cap)
    assert all(torch.equal(a, b) for a, b in zip((pos, has, neg), again))
    if d == 8:  # uniform over the valid slots: each of a full row's 8 slots about 1/8 of the time
        full = torch.ones((4000, 8), dtype=torch.bool)
        ids = torch.arange(8, dtype=torch.int32).repeat(4000, 1)
        p, _, _ = tgs.sample_pairs(torch.Generator().manual_seed(9), ids, full, cap)
        counts = np.bincount(p.numpy(), minlength=8)
        assert counts.min() > 400 and counts.max() < 600, counts


@pytest.mark.parametrize("c,f_in,f_out,k,d", [(40, 16, 8, 30, 0), (40, 16, 8, 30, 4), (50, 12, 20, 7, 40),
                                              (64, 32, 32, 5, 300)])
def test_sage_layer_backward_plain_matches_autograd(c, f_in, f_out, k, d):
    """The backward twin against torch.autograd of the forward twin, and
    SageLayerFn (on the CPU: both twins) against both, at D = 0 (the
    contexts' empty neighborhood) and past 32 slots."""
    rng = np.random.default_rng(c + d)
    table = torch.from_numpy(rng.normal(size=(c, f_in)).astype(np.float32)).to(torch.bfloat16)
    keys = torch.from_numpy(rng.integers(-c, c + 6, k).astype(np.int32))
    nbrs = torch.from_numpy(rng.integers(-c, c + 6, (k, d)).astype(np.int32))
    valid = torch.from_numpy(rng.random((k, d)) < 0.7)
    w = torch.from_numpy(rng.normal(size=(2 * f_in, f_out)).astype(np.float32) / f_in ** 0.5).requires_grad_()
    bias = torch.from_numpy(rng.normal(size=f_out).astype(np.float32) * 0.1).requires_grad_()
    dz = torch.from_numpy(rng.normal(size=(k, f_out)).astype(np.float32)).to(torch.bfloat16)
    wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    z = sage.sage_layer_plain(table, keys, nbrs, valid, wb, bb)
    want_w, want_b = torch.autograd.grad(z, [w, bias], dz)
    dw, db = torch.zeros(2 * f_in, f_out), torch.zeros(f_out)
    before = dict(sage.LAUNCHES)
    sage.sage_layer_backward(table, keys, nbrs, valid, z.detach(), dz, dw, db)
    zf = sage.SageLayerFn.apply(table, keys, nbrs, valid, wb, bb)
    fn_w, fn_b = torch.autograd.grad(zf, [w, bias], dz)
    assert sage.LAUNCHES == before  # CPU tensors: the twins, no launch
    assert torch.equal(zf, z)
    # autograd rounds the gradient of a bf16 input to bf16 before the f32 cast
    torch.testing.assert_close(dw.to(torch.bfloat16).float(), want_w, rtol=0, atol=0)
    torch.testing.assert_close(db.to(torch.bfloat16).float(), want_b, rtol=0, atol=0)
    assert torch.equal(fn_w, want_w) and torch.equal(fn_b, want_b)
    if d == 0:
        assert not dw[f_in:].any()  # the mean is 0: W_nbr gains nothing
        self_only = torch.relu(table[sage.indexing.gather_index(keys, c)].float() @ wb[:f_in].float() + bb.float())
        assert torch.equal(z, self_only.to(torch.bfloat16))


def test_refusals():
    f, k, d = 8, 4, 3
    table = torch.zeros((10, f), dtype=torch.bfloat16)
    keys = torch.zeros(k, dtype=torch.int32)
    nbrs = torch.zeros((k, d), dtype=torch.int32)
    valid = torch.ones((k, d), dtype=torch.bool)
    z = torch.ones((k, 5), dtype=torch.bfloat16)
    dw, db = torch.zeros((2 * f, 5)), torch.zeros(5)
    args = [table, keys, nbrs, valid, z, z.clone(), dw, db]
    for i, bad, match in [(4, z.float(), "z must be"), (5, z[:, :4].contiguous(), "dz must be"),
                          (6, dw.to(torch.bfloat16), "dw must be"), (6, torch.zeros((f, 5)), "dw must be"),
                          (7, db.double(), "db must be"), (0, table.float(), "table must be"),
                          (6, torch.zeros((2 * f, 5), device="meta"), "every input must lie on")]:
        with pytest.raises(ValueError, match=match):
            sage.sage_layer_backward(*args[:i], bad, *args[i + 1:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no sage_layer_backward kernel for device meta"):
        sage.sage_layer_backward(*meta)
    for fn in (tgs.sage_loss_mesh, tgs.sage_train_step_mesh):
        with pytest.raises(NotImplementedError, match="queue A, item 8"):
            fn(None, None)
    with pytest.raises(ValueError, match="the generator lies on"):
        tgs.sample_pairs(torch.Generator(), nbrs.to("meta"), valid.to("meta"), 10)
    with pytest.raises(ValueError, match="mu, nu and count come together"):
        interop.sage_train_state_from_numpy(np.zeros((f, 5)), np.zeros((f, 5)), np.zeros(5), lr=LR,
                                            mu=[np.zeros((f, 5))] * 2 + [np.zeros(5)], device="cpu")
    if not torch.cuda.is_available():  # the training entry points default to the GPU
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            tgs.sage_init_train(f, 5, lr=LR, generator=torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            interop.sage_train_state_from_numpy(np.zeros((f, 5)), np.zeros((f, 5)), np.zeros(5), lr=LR)
