"""The port's training path against the JAX package's, on the CPU, at a tiny
config (2 layers, E=64, 4 heads, L=64, vocab 128) with the same
JAX-initialized parameters: logits, the masked-MLE loss and every gradient
through flash attention at 1e-5 in fp32 (the JAX side runs its Pallas
kernels in interpret mode); one SGD training step, plain and with two
accumulated microbatches, at 1e-6; Adam, AdamW, mixed precision, clipping
and the schedule on identical gradients at 1e-6 (Adam moves every parameter by about lr at its first step whatever the
gradient's size, so it is judged on the same gradients, not on two
packages' own); dropout's keep rate and scaling; the epoch loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.apps import machine_translation as jmt
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tmt
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn import optim as topt

torch.set_num_threads(1)

CFG = dict(n_vocab=128, n_embd=64, n_head=4, n_positions=64, n_layer=2,
           ff_middle_dim=128, p_dropout=0.0, attention_kind="flash")
B, L = 2, 64
TIGHT = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=1e-6, rtol=1e-6)


def tree_np(tree):
    return {n: np.asarray(x, np.float32)
            for n, x in tnn.named_tree_leaves(tree)}


def grads_as_jax(model):
    """The port's .grad of every parameter, in the JAX layout."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, tnn.Linear)}
    return {n: (p.grad.T if n in linear else p.grad).numpy()
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def pair():
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, CFG["n_vocab"], (B, L)),
             "labels": rng.integers(0, CFG["n_vocab"], (B, L)),
             "label_token_weights": (rng.random((B, L)) > 0.3
                                     ).astype(np.float32)}
    return jm, params, tm, batch


def jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def test_flash_logits_match_jax_and_naive(pair):
    jm, params, tm, batch = pair
    want = jax.jit(jm)(params, jnp.asarray(batch["input_ids"], jnp.int32))
    ids = torch.from_numpy(batch["input_ids"])
    got = tm(ids)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TIGHT)
    naive = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind":
                                               "naive"}), device="cpu")
    naive.load_state_dict(tm.state_dict())
    torch.testing.assert_close(naive(ids), got, **TIGHT)


def test_loss_and_gradients_match_jax(pair):
    jm, params, tm, batch = pair
    loss_j, grads_j = jax.jit(jax.value_and_grad(jmt.make_loss_fn(jm)))(
        params, jax_batch(batch))
    tm.zero_grad()
    loss = tmt.make_loss_fn(tm)(tmt.place_batch(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TIGHT)
    got, want = grads_as_jax(tm), tree_np(grads_j)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TIGHT)


def test_sgd_training_step_matches_jax(pair):
    jm, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    jopt, topt_ = jnn.sgd(lr=0.1), tnn.sgd(lr=0.1)
    jstep = jmt.make_train_step(jm, jopt)
    new_j, _, loss_j = jstep(params, jopt.init(params), jax_batch(batch),
                             jax.random.key(1))
    step = tmt.make_train_step(tm, topt_)
    state = topt_.init(dict(tm.named_parameters()))
    state, loss = step(state, tmt.place_batch(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(loss_j), **TIGHT)
    got, want = tree_np(tnn.to_jax_params(tm)), tree_np(new_j)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP)


def test_accumulated_training_step_matches_jax(pair):
    """accum_steps=2: two microbatches of one row, fp32 gradients averaged,
    one SGD update; the loss at 1e-5 and the parameters at 1e-6."""
    jm, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    jopt, topt_ = jnn.sgd(lr=0.1), tnn.sgd(lr=0.1)
    new_j, _, loss_j = jmt.make_train_step(jm, jopt, accum_steps=2)(
        params, jopt.init(params), jax_batch(batch), jax.random.key(1))
    step = tmt.make_train_step(tm, topt_, accum_steps=2)
    _, loss = step(topt_.init(dict(tm.named_parameters())),
                   tmt.place_batch(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(loss_j), **TIGHT)
    got, want = tree_np(tnn.to_jax_params(tm)), tree_np(new_j)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP)


def random_trees(rng, dtype=np.float32, steps=3):
    shapes = {"a.weight": (5, 7), "a.bias": (7,), "b.gamma": (3,)}
    params = {n: rng.standard_normal(s).astype(dtype)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
              for n, s in shapes.items()} for i in range(steps)]
    return params, grads


def run_both(jtx, ttx, params, grads, cast=None):
    """Steps both optimizers on the same gradients; returns the final
    params of each as numpy (and the states)."""
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    if cast is not None:
        jp = {n: v.astype(jnp.bfloat16) for n, v in jp.items()}
        tp = {n: v.to(torch.bfloat16) for n, v in tp.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        jp, js = jtx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        tp, ts = ttx.update({n: torch.from_numpy(v) for n, v in g.items()},
                            ts, tp)
    return ({n: np.asarray(v, np.float32) for n, v in jp.items()},
            {n: v.float().numpy() for n, v in tp.items()}, js, ts)


@pytest.mark.parametrize("compat", [False, True])
def test_adam_matches_jax_on_identical_gradients(rng, compat):
    params, grads = random_trees(rng)
    want, got, js, ts = run_both(
        jnn.adam(lr=1e-2, minitorch_compat=compat),
        tnn.adam(lr=1e-2, minitorch_compat=compat), params, grads)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP)
    assert ts.step == int(js.step) == 3
    for n in params:
        np.testing.assert_allclose(ts.exp_avg_sq[n].numpy(),
                                   np.asarray(js.exp_avg_sq[n]), **STEP)


def test_mixed_precision_matches_jax(rng):
    """bf16 parameters, fp32 masters in the state: the bf16 round trip and
    the masters agree with the JAX package's."""
    params, grads = random_trees(rng)
    want, got, js, ts = run_both(jnn.mixed_precision(jnn.adam(lr=1e-2)),
                                 tnn.mixed_precision(tnn.adam(lr=1e-2)),
                                 params, grads, cast=jnp.bfloat16)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        np.testing.assert_allclose(ts.master[n].numpy(),
                                   np.asarray(js.master[n]), **STEP)
        assert ts.master[n].dtype == torch.float32


def test_adamw_schedule_and_clipping_match_jax(rng):
    params, grads = random_trees(rng, steps=4)
    want, got, _, _ = run_both(
        jnn.adamw(lr=jnn.cosine_schedule(1e-2, 2, 4)),
        topt.adamw(lr=topt.cosine_schedule(1e-2, 2, 4)), params, grads)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP)
    from tpu_flash.nn.optim import clip_by_global_norm as jclip
    g = {n: v * 100 for n, v in grads[0].items()}
    jc, jn = jclip({n: jnp.asarray(v) for n, v in g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm(
        {n: torch.from_numpy(v) for n, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for n in g:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **STEP)


def test_loss_functions_match_jax(rng):
    x = rng.standard_normal((3, 5, 11)).astype(np.float32)
    t = rng.integers(0, 11, (3, 5))
    np.testing.assert_allclose(
        F.logsumexp(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.functional.logsumexp(jnp.asarray(x))), **TIGHT)
    np.testing.assert_allclose(
        F.logsoftmax(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.functional.logsoftmax(jnp.asarray(x))), **TIGHT)
    np.testing.assert_allclose(
        F.softmax_loss(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(jnn.functional.softmax_loss(jnp.asarray(x),
                                               jnp.asarray(t))), **TIGHT)


def test_dropout_keep_rate_and_scaling():
    """Not held against jax.random (its bits cannot be reproduced in
    torch): the keep rate, the 1/(1-p) scaling, and the seed."""
    x = torch.ones(200_000)
    y = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    no_rescale = F.dropout(x, 0.25, rescale=False,
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(no_rescale, kept.float())
    for kw in (dict(training=False), dict(generator=None)):
        kw.setdefault("generator", torch.Generator())
        assert F.dropout(x, 0.25, **kw) is x
    assert F.dropout(x, 0.0, generator=torch.Generator()) is x


def test_training_dropout_in_the_model(pair):
    _, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "p_dropout": 0.1}),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    ids = torch.from_numpy(batch["input_ids"])
    ev = tm(ids)
    a = tm(ids, training=True, generator=torch.Generator().manual_seed(3))
    b = tm(ids, training=True, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, ev)
    torch.testing.assert_close(tm(ids, training=True), ev, rtol=0, atol=0)


def test_train_step_and_epoch_without_a_generator_drop_out(pair):
    """The JAX step always takes a key, so a step or an epoch given no
    generator draws its dropout from one of its own (the step's seeded with
    0, the epoch's with its ``seed``)."""
    _, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "p_dropout": 0.1}),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    placed = tmt.place_batch(batch, "cpu")
    with torch.no_grad():
        eval_loss = float(tmt.make_loss_fn(tm)(placed))
    opt = tnn.sgd(lr=0.0)                 # the parameters stay as they are
    state = opt.init(dict(tm.named_parameters()))
    _, own = tmt.make_train_step(tm, opt)(state, placed)
    _, zero = tmt.make_train_step(tm, opt)(
        state, placed, torch.Generator().manual_seed(0))
    _, given = tmt.make_train_step(tm, opt)(
        state, placed, torch.Generator().manual_seed(3))
    assert float(own) == float(zero) != eval_loss
    _, losses, _, _ = tmt.train_epoch(tm, opt, state, [0, 1],
                                      lambda _: dict(batch), 1, seed=3,
                                      log=None)
    assert losses[0] == float(given) and losses[1] not in (losses[0],
                                                          eval_loss)


def test_place_batch_keeps_tensors_and_scalars():
    ids = torch.arange(6).reshape(2, 3)
    out = tmt.place_batch({"input_ids": ids,
                           "weights": np.ones((2, 3), np.float32),
                           "loss_norm": np.float32(6.0)}, "cpu")
    assert out["input_ids"] is ids
    assert out["weights"].dtype == torch.float32
    assert out["weights"].shape == (2, 3)
    assert out["loss_norm"].dim() == 0 and float(out["loss_norm"]) == 6.0


def test_to_jax_params_round_trips(pair):
    _, params, tm, _ = pair
    tree = tnn.to_jax_params(tm)
    want = tree_np(params)
    got = tree_np(tree)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    other = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(other, tree)
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), n


def test_train_epoch_matches_jax_and_the_loss_falls(pair):
    """Three SGD steps on one repeated batch through both epoch loops:
    the same losses, falling; the port's evaluate_loss after them agrees
    with the JAX package's on the JAX package's updated parameters."""
    jm, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    examples = list(range(6))

    def collate(_):
        return dict(batch)

    jopt, topt_ = jnn.sgd(lr=0.5), tnn.sgd(lr=0.5)
    new_j, _, want, _, _ = jmt.train_epoch(
        jm, jopt, params, jopt.init(params), examples,
        lambda ex: jax_batch(batch), 2, jax.random.key(0), log_every=2)
    _, got, step_times, tokens = tmt.train_epoch(
        tm, topt_, topt_.init(dict(tm.named_parameters())), examples,
        collate, 2, log_every=2, log=None)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert got[2] < got[1] < got[0]
    assert tokens == B * L and len(step_times) == 2
    np.testing.assert_allclose(
        tmt.evaluate_loss(tm, examples[:2], collate, 2),
        jmt.evaluate_loss(jm, new_j, examples[:2],
                          lambda ex: jax_batch(batch), 2), **TIGHT)


def test_bf16_mixed_precision_step_keeps_dtypes(pair):
    _, params, _, batch = pair
    tm = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "dtype": torch.bfloat16,
                                            "p_dropout": 0.1}), device="cpu")
    tnn.load_jax_params(tm, params)
    opt = tnn.mixed_precision(tnn.adam(lr=1e-3))
    step = tmt.make_train_step(tm, opt)
    state = opt.init(dict(tm.named_parameters()))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(3):
        state, loss = step(state, tmt.place_batch(batch, "cpu"), gen)
        losses.append(float(loss))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(m.dtype == torch.float32 for m in state.master.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_unported_training_options_raise(pair):
    """chunked_vocab is ported; its vocab- and data-parallel forms are not
    (A8)."""
    x, w = torch.zeros(4, 8), torch.zeros(10, 8)
    y = torch.zeros(4, dtype=torch.long)
    for kw in (dict(axis_name="model"), dict(batch_axis="data")):
        with pytest.raises(NotImplementedError, match="A8"):
            F.chunked_softmax_loss(x, w, None, y, **kw)


@pytest.mark.parametrize("chunks", [0, 4])
def test_train_epoch_passes_chunked_vocab_to_its_step(pair, monkeypatch,
                                                      chunks):
    """``train_epoch(..., chunked_vocab=n)`` without a step builds
    ``make_train_step(model, opt, chunked_vocab=n)``, as the JAX loop does:
    its losses and parameters are the bits of an epoch given that step."""
    _, params, _, batch = pair
    built = []

    def spy(model, opt, chunked_vocab=0, **kw):
        built.append(chunked_vocab)
        return make(model, opt, chunked_vocab=chunked_vocab, **kw)

    make = tmt.make_train_step
    monkeypatch.setattr(tmt, "make_train_step", spy)
    runs = []
    for own in (False, True):
        tm = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "p_dropout": 0.1}),
                           device="cpu")
        tnn.load_jax_params(tm, params)
        opt = tnn.sgd(lr=0.5)
        step = None if own else tmt.make_train_step(tm, opt,
                                                    chunked_vocab=chunks)
        kw = {"chunked_vocab": chunks} if own else {}
        _, losses, _, _ = tmt.train_epoch(
            tm, opt, opt.init(dict(tm.named_parameters())), list(range(6)),
            lambda _: dict(batch), 2, seed=1, train_step=step, log=None,
            **kw)
        runs.append((losses, {n: p.detach().clone()
                              for n, p in tm.named_parameters()}))
    assert built == [chunks, chunks]
    (l0, p0), (l1, p1) = runs
    assert l0 == l1 and l0[-1] < l0[0]
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
