"""The port's long-context training path against the JAX package's, on the
CPU at small sizes: (a) the backward's form (fused or two passes) equals
the JAX selector's over a grid of shapes; (b) the two-pass plain halves
against JAX's two-pass backward in interpret mode (forced as
tests/test_flash_kernels.py forces it) at the reference tolerances,
forward 1e-3 and backward 1e-2, and against the port's fused plain version
at 1e-6; (c) ``remat`` equal to no remat bit for bit with dropout from one
seeded generator (and a naive ``checkpoint`` wrap shown to break that), and
against JAX's ``remat`` at 1e-5; (d) ``chunked_softmax_loss`` and
``make_loss_fn(chunked_vocab=...)`` against JAX's at 1e-5; (e) a 2-layer
model whose backward takes the two-pass plain form, against ``jax.grad``
with the JAX two-pass forced, at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.apps import machine_translation as jmt
from tpu_flash.kernels import flash_attention as jfa
from tpu_flash.kernels.common import round_up
from tpu_flash.nn import functional as jF
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tmt
from tpu_flash_torch.kernels import backward_form
from tpu_flash_torch.kernels import flash_attention as tfa
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn import transformer as ttr

torch.set_num_threads(1)

FW_TOL = dict(atol=1e-3, rtol=1e-3)
BW_TOL = dict(atol=1e-2, rtol=1e-3)
TIGHT = dict(atol=1e-5, rtol=1e-5)
CFG = dict(n_vocab=131, n_embd=64, n_head=2, n_positions=64, n_layer=2,
           ff_middle_dim=96, p_dropout=0.0, attention_kind="flash")
B, L = 2, 64


def jax_two_pass(Lq, Lk, d, itemsize, causal, window=None):
    """The JAX entry's clamps (flash_attention.py:1783-1794) and its
    selector's verdict."""
    block_k = min(jfa.DEFAULT_BLOCK_K_BWD, round_up(Lk, 8))
    if itemsize >= 4:
        block_k = min(block_k, 512)
    return not jfa.select_bwd_fused_config(
        Lq, Lk, d, block_q=None, block_k=block_k, causal=causal,
        q_offset=Lk - Lq, itemsize=itemsize, window=window)[0]


# --- (a) the backward's form -------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("L", [64, 1000, 2048, 4096, 8192, 16384, 32768])
def test_form_equals_the_jax_selector(L, itemsize):
    for d in (16, 32, 64, 128):
        for causal in (True, False):
            want = jax_two_pass(L, L, d, itemsize, causal)
            assert backward_form.two_pass(L, L, d, itemsize, causal) == want, \
                (L, d, itemsize, causal)


@pytest.mark.parametrize("Lq,Lk,window", [
    (8192, 16384, None), (16384, 8192, None), (1, 32768, None),
    (100, 20000, None), (20000, 100, None), (16384, 16384, 256),
    (8192, 8192, 1024), (32768, 32768, 4096), (4000, 12000, 512)])
def test_form_equals_the_jax_selector_off_the_diagonal(Lq, Lk, window):
    for d in (64, 128):
        for itemsize in (2, 4):
            causals = (True,) if window else (True, False)
            for causal in causals:
                want = jax_two_pass(Lq, Lk, d, itemsize, causal, window)
                got = backward_form.two_pass(Lq, Lk, d, itemsize, causal,
                                             window=window)
                assert got == want, (Lq, Lk, d, itemsize, causal, window)


def test_form_at_the_issue_boundaries():
    """Causal, Lq = Lk: bf16 takes two passes from 16384, fp32 from 8192
    (d 64) and 4096 (d 128)."""
    for itemsize, d, first in ((2, 64, 16384), (2, 128, 16384),
                               (4, 64, 8192), (4, 128, 4096)):
        for L in (first // 2, first):
            assert backward_form.two_pass(L, L, d, itemsize, True) == (
                L == first)


# --- (b) the two-pass plain halves against JAX's two-pass --------------------

@pytest.fixture
def jax_two_pass_forced(monkeypatch):
    """The JAX backward forced to its two-pass form (its fused footprint
    caps set to 1 byte), with jit caches cleared around the test so that
    no executable of either form leaks into another test."""
    jax.clear_caches()
    monkeypatch.setattr(jfa, "_FUSED_VMEM_CAP_BF16", 1)
    monkeypatch.setattr(jfa, "_FUSED_VMEM_CAP_FP32", 1)
    yield
    jax.clear_caches()


def draw(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("Bq,H,Hkv,Lq,Lk,d,causal,with_dlse", [
    (1, 2, 2, 256, 256, 32, True, False),
    (1, 4, 2, 200, 200, 32, True, True),         # GQA, ragged L, dlse
    (1, 2, 2, 130, 70, 16, True, False),         # Lq > Lk: 60 empty rows
    (1, 2, 2, 70, 130, 16, True, True),          # Lq < Lk
    (2, 2, 1, 96, 160, 32, False, False),        # MQA, not causal
])
def test_two_pass_halves_match_jax_two_pass(rng, jax_two_pass_forced, Bq, H,
                                            Hkv, Lq, Lk, d, causal,
                                            with_dlse):
    q, k, v, do, dl = draw(rng, (Bq, H, Lq, d), (Bq, Hkv, Lk, d),
                           (Bq, Hkv, Lk, d), (Bq, H, Lq, d), (Bq, H, Lq))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tdl = torch.from_numpy(dl) if with_dlse else None
    out, lse, _ = tfa.flash_attention_forward(tq, tk, tv, causal=causal)
    jout, jlse, _ = jfa.flash_attention_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FW_TOL)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(np.asarray(jlse)))
    want = jfa.flash_attention_backward.__wrapped__(
        *(jnp.asarray(x) for x in (q, k, v, out.numpy(), lse.numpy(), do)),
        jnp.asarray(dl) if with_dlse else None, causal=causal,
        interpret=True)
    args = (tq, tk, tv, out, lse, tdo, tdl)
    dk, dv = tfa.flash_attention_backward_dkv_plain(*args, causal=causal)
    dq = tfa.flash_attention_backward_dq_plain(*args, causal=causal)
    two = tfa.flash_attention_backward_two_pass(*args, causal=causal)
    fused = tfa.flash_attention_backward_fused(*args, causal=causal)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **BW_TOL)
    for a, b, c in zip((dq, dk, dv), two, fused):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        torch.testing.assert_close(b, c, atol=1e-6, rtol=1e-6)
    if causal and Lq > Lk:
        assert torch.count_nonzero(dq[:, :, :Lq - Lk]) == 0


def test_two_pass_bf16_rounds_as_the_fused_plain_version(rng):
    """bf16: the halves round P and dS where the fused plain version does,
    so their outputs are the same bits."""
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in draw(
        rng, (1, 4, 96, 32), (1, 2, 96, 32), (1, 2, 96, 32), (1, 4, 96, 32)))
    out, lse, _ = tfa.flash_attention_forward(q, k, v, causal=True)
    args = (q, k, v, out, lse, do)
    for a, b in zip(tfa.flash_attention_backward_two_pass(*args, causal=True),
                    tfa.flash_attention_backward_fused(*args, causal=True)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dispatch_follows_the_form(monkeypatch, rng):
    """``flash_attention_backward`` runs the two-pass halves where the form
    says two passes, the fused plain version elsewhere."""
    calls = []
    for name in ("_dkv_plain", "_dq_plain", "flash_attention_backward_plain"):
        real = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name, lambda *a, _r=real, _n=name, **kw: (calls.append(_n),
                                                          _r(*a, **kw))[1])
    q, k, v, do = (torch.from_numpy(x) for x in draw(rng, *[(1, 2, 64, 16)]
                                                     * 4))
    out, lse, _ = tfa.flash_attention_forward(q, k, v, causal=True)
    fused = tfa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert calls == ["flash_attention_backward_plain"]
    monkeypatch.setattr(tfa, "two_pass", lambda *a, **kw: True)
    two = tfa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert calls[1:] == ["_dkv_plain", "_dq_plain"]
    for a, b in zip(two, fused):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# --- (c) remat ----------------------------------------------------------------

def port_model(**over):
    m = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, **over}), device="cpu")
    tnn.init_params(m, torch.Generator().manual_seed(0))
    return m


def host_batch(seed=7, n_vocab=CFG["n_vocab"]):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, n_vocab, (B, L)),
            "labels": rng.integers(0, n_vocab, (B, L)),
            "label_token_weights": (rng.random((B, L)) > 0.3
                                    ).astype(np.float32)}


def loss_and_grads(model, batch, generator=None, chunked_vocab=0):
    model.zero_grad()
    loss = tmt.make_loss_fn(model, chunked_vocab=chunked_vocab)(
        tmt.place_batch(batch, "cpu"), generator=generator,
        training=generator is not None)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def naive_remat(layer, x, *, generator, **kw):
    """``checkpoint`` around the layer with the caller's generator: the
    recompute draws other dropout masks than the forward did."""
    return torch.utils.checkpoint.checkpoint(
        lambda t: layer(t, generator=generator, **kw), x,
        use_reentrant=False)


@pytest.mark.parametrize("wrap", ["restored", "naive"])
def test_remat_equals_no_remat_bit_for_bit_with_dropout(monkeypatch, wrap):
    """p_dropout 0.1, one seeded generator: the loss, every gradient and the
    generator's state after the step are the same bits with and without
    remat.  A naive wrap (the caller's generator in the recompute) gives
    other gradients, which is what the captured state prevents."""
    if wrap == "naive":
        monkeypatch.setattr(ttr, "_remat_layer", naive_remat)
    batch = host_batch()
    runs = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(5)
        model = port_model(p_dropout=0.1, remat=remat)
        runs[remat] = (*loss_and_grads(model, batch, gen), gen.get_state())
    (loss0, g0, s0), (loss1, g1, s1) = runs[False], runs[True]
    assert torch.equal(loss0, loss1)
    same = all(torch.equal(g0[n], g1[n]) for n in g0)
    if wrap == "restored":
        assert same and torch.equal(s0, s1)
    else:
        assert not same


def test_remat_under_no_grad_and_without_training(rng):
    model, plain = port_model(remat=True), port_model()
    ids = torch.from_numpy(rng.integers(0, CFG["n_vocab"], (B, L)))
    with torch.no_grad():
        torch.testing.assert_close(model(ids), plain(ids), rtol=0, atol=0)


def test_remat_matches_jax_remat():
    """p_dropout 0: the port's remat step against JAX's remat step (its
    jax.checkpoint per layer), loss and every gradient at 1e-5."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, remat=True))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, remat=True), device="cpu")
    tnn.load_jax_params(tm, params)
    batch = host_batch()
    loss_j, grads_j = jax.jit(jax.value_and_grad(jmt.make_loss_fn(jm)))(
        params, jax_batch(batch))
    loss, grads = loss_and_grads(tm, batch)
    np.testing.assert_allclose(float(loss), float(loss_j), **TIGHT)
    compare_grads(tm, grads, grads_j)


def jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def compare_grads(model, grads, grads_j):
    """Port gradients (``Linear`` weights ``[out, in]``) against a JAX
    gradient tree (``[in, out]``)."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, tnn.Linear)}
    want = {n: np.asarray(x, np.float32)
            for n, x in tnn.named_tree_leaves(grads_j)}
    assert want.keys() == grads.keys()
    for n, g in grads.items():
        got = (g.T if n in linear else g).numpy()
        np.testing.assert_allclose(got, want[n], err_msg=n, **TIGHT)


# --- (d) the chunked-vocab loss ----------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n_chunks", [1, 4, 7])
def test_chunked_softmax_loss_matches_jax(rng, with_bias, n_chunks):
    """V = 131 is no multiple of 4 or 7: the last chunk is padded."""
    N, E, V = 37, 24, 131
    x, w, b, gl = draw(rng, (N, E), (V, E), (V,), (N,))
    y = rng.integers(0, V, (N,))
    bias = b if with_bias else None

    def jloss(x, wt, b):
        return jnp.sum(jF.chunked_softmax_loss(x, wt, b, jnp.asarray(y),
                                               n_chunks=n_chunks) * gl)

    jargs = (jnp.asarray(x), jnp.asarray(w.T),
             None if bias is None else jnp.asarray(bias))
    want = jF.chunked_softmax_loss(*jargs, jnp.asarray(y), n_chunks=n_chunks)
    argnums = (0, 1, 2) if with_bias else (0, 1)
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              ((x, w, b) if with_bias else (x, w))]
    got = F.chunked_softmax_loss(leaves[0], leaves[1],
                                 leaves[2] if with_bias else None,
                                 torch.from_numpy(y), n_chunks=n_chunks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TIGHT)
    (got * torch.from_numpy(gl)).sum().backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(jgrads[0]),
                               **TIGHT)
    np.testing.assert_allclose(leaves[1].grad.numpy(),
                               np.asarray(jgrads[1]).T, **TIGHT)
    if with_bias:
        np.testing.assert_allclose(leaves[2].grad.numpy(),
                                   np.asarray(jgrads[2]), **TIGHT)
    full = F.softmax_loss(leaves[0] @ leaves[1].T
                          + (leaves[2] if with_bias else 0),
                          torch.from_numpy(y))
    torch.testing.assert_close(got, full, **TIGHT)


def test_chunked_softmax_loss_bf16_keeps_dtypes(rng):
    x, w, b = (torch.from_numpy(a).bfloat16().requires_grad_() for a in
               draw(rng, (2, 5, 16), (50, 16), (50,)))
    y = torch.from_numpy(rng.integers(0, 50, (2, 5)))
    loss = F.chunked_softmax_loss(x, w, b, y, n_chunks=3)
    assert loss.shape == (2, 5) and loss.dtype == torch.float32
    loss.sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.bfloat16
    full = F.softmax_loss(x.float() @ w.float().T + b.float(), y)
    torch.testing.assert_close(loss, full, **TIGHT)


def test_chunked_loss_fn_matches_unchunked_and_jax():
    """``make_loss_fn(chunked_vocab=4)`` against ``chunked_vocab=0`` in the
    port and against JAX's ``make_loss_fn(model, chunked_vocab=4)``: the
    loss and every gradient at 1e-5; ``return_hidden`` gives the post-LN
    state whose lm_head product is the logits."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(1))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    batch = host_batch(9)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        jmt.make_loss_fn(jm, chunked_vocab=4)))(params, jax_batch(batch))
    loss4, grads4 = loss_and_grads(tm, batch, chunked_vocab=4)
    loss0, grads0 = loss_and_grads(tm, batch)
    np.testing.assert_allclose(float(loss4), float(loss_j), **TIGHT)
    np.testing.assert_allclose(float(loss4), float(loss0), **TIGHT)
    compare_grads(tm, grads4, grads_j)
    for n in grads0:
        torch.testing.assert_close(grads4[n], grads0[n], **TIGHT)
    ids = torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        hidden = tm(ids, return_hidden=True)
        jhidden = jm(params, jnp.asarray(batch["input_ids"], jnp.int32),
                     return_hidden=True)
        assert hidden.shape == (B, L, CFG["n_embd"])
        np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                                   **TIGHT)
        torch.testing.assert_close(tm.lm_head(hidden), tm(ids), rtol=0,
                                   atol=0)
    assert np.isclose(tmt.evaluate_loss(tm, [0], lambda _: batch, 1,
                                        chunked_vocab=4), float(loss0),
                      rtol=1e-5)


def test_chunked_train_step_with_remat_trains():
    """SGD steps with remat, dropout and chunked_vocab=8: the loss falls on
    a repeated batch."""
    model = port_model(p_dropout=0.1, remat=True)
    opt = tnn.sgd(lr=0.5)
    step = tmt.make_train_step(model, opt, chunked_vocab=8)
    state = opt.init(dict(model.named_parameters()))
    batch = tmt.place_batch(host_batch(), "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --- (e) a model whose backward takes the two passes --------------------------

def test_model_with_two_pass_backward_matches_jax(monkeypatch,
                                                  jax_two_pass_forced):
    """2 layers at L = 64, the port's backward routed to the two-pass plain
    halves (and shown to run them once a layer), the JAX backward forced to
    its two-pass kernels: loss and every gradient at 1e-5."""
    monkeypatch.setattr(tfa, "two_pass", lambda *a, **kw: True)
    calls = []
    real = tfa._dkv_plain
    monkeypatch.setattr(tfa, "_dkv_plain",
                        lambda *a: (calls.append(1), real(*a))[1])
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(2))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    batch = host_batch(11)
    loss_j, grads_j = jax.value_and_grad(jmt.make_loss_fn(jm))(
        params, jax_batch(batch))
    loss, grads = loss_and_grads(tm, batch)
    assert len(calls) == CFG["n_layer"]
    np.testing.assert_allclose(float(loss), float(loss_j), **TIGHT)
    compare_grads(tm, grads, grads_j)
