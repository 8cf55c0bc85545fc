"""The port's routed MoE feed-forward and the rotary + MoE decoder against
the JAX package's, with the same JAX-initialized parameters loaded through
``load_jax_params`` and inputs from a numpy seed:

* ``MoEFeedForward``: ``(y, aux)`` in top-1 and top-2 at capacity factors
  0.75 (tokens dropped) and 4.0 (none), fp32 within 1e-5, and the gradient
  of ``sum(y) + aux`` for the input and every parameter within 1e-5; bf16
  within 2e-2 (the gates and products round at other places); router noise
  and dropout by their statistics (their bits are the torch generator's);
* ``DecoderLM(positional="rope", moe=...)``: logits, ``aux_total`` and
  gradients on the flash, naive, fused and remat routes within 1e-5, the
  parameter tree and init, and one Adam step on ``ce + aux_weight * aux``.

``tests/test_torch_rope.py`` holds the same model's cached decode and
serving."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.nn.moe import MoEConfig as JaxMoEConfig
from tpu_flash.nn.moe import MoEFeedForward as JaxMoE
from tpu_flash_torch import nn as tnn

torch.set_num_threads(1)

E, FF, X = 32, 48, 4
MOE = dict(n_experts=X, top_k=2, capacity_factor=1.25)
CFG = dict(n_vocab=64, n_embd=E, n_head=4, n_positions=64, n_layer=2,
           ff_middle_dim=FF, p_dropout=0.0, positional="rope")
F32 = dict(atol=1e-5, rtol=1e-5)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def ff_pair(top_k, cf, dtype="float32", seed=0, p_dropout=0.0):
    jcfg = JaxMoEConfig(n_experts=X, top_k=top_k, capacity_factor=cf)
    jff = JaxMoE(E, FF, jcfg, getattr(jnp, dtype), p_dropout=p_dropout)
    params = jff.init(jax.random.key(seed))
    tff = tnn.MoEFeedForward(
        E, FF, tnn.MoEConfig(n_experts=X, top_k=top_k, capacity_factor=cf),
        getattr(torch, dtype), p_dropout=p_dropout, device="cpu")
    tnn.load_jax_params(tff, params)
    return jff, params, tff


@pytest.mark.parametrize("top_k,cf", [(1, 0.75), (1, 4.0), (2, 0.75),
                                      (2, 4.0)])
def test_moe_feed_forward_matches_jax(rng, top_k, cf):
    """y, aux and the gradients of sum(y) + aux; at 0.75 tokens are
    dropped, at 4.0 none."""
    jff, params, tff = ff_pair(top_k, cf)
    x = rng.standard_normal((2, 12, E)).astype(np.float32)

    def objective(p, x):
        y, aux = jff(p, x)
        return jnp.sum(y) + aux, (y, aux)

    (_, (y_j, aux_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tff(xt)
    (y.sum() + aux).backward()
    np.testing.assert_allclose(np32(y), np32(y_j), **F32)
    np.testing.assert_allclose(np32(aux), np32(aux_j), **F32)
    np.testing.assert_allclose(np32(xt.grad), np32(gx_j), **F32)
    for n, p in tff.named_parameters():
        np.testing.assert_allclose(np32(p.grad), np32(gp_j[n]), err_msg=n,
                                   **F32)
    T = x.shape[0] * x.shape[1]
    dispatch, _, _ = tff._route(tff.router_logits(xt.reshape(T, E)),
                                capacity=tff.capacity(T))
    routed = int(dispatch.sum())
    assert (routed < top_k * T) if cf < 1 else (routed == top_k * T)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_feed_forward_bf16_close_to_jax(rng, top_k):
    """bf16 parameters and input: the gates are cast to bf16 before their
    products in both packages, whose bf16 products and GELU round at
    other places, so y (|y| < 1) agrees to 2e-2; aux (fp32 routing on the
    same bf16 tokens) to 1e-5."""
    jff, params, tff = ff_pair(top_k, 1.25, "bfloat16")
    x = rng.standard_normal((2, 12, E)).astype(np.float32)
    y_j, aux_j = jax.jit(jff)(params, jnp.asarray(x, jnp.bfloat16))
    y, aux = tff(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(np32(y), np32(y_j), atol=2e-2, rtol=0)
    np.testing.assert_allclose(np32(aux), np32(aux_j), **F32)


def probe_ff(router_noise=0.0, p_dropout=0.0):
    """A top-1 layer whose output shows its routing: a zero input gives
    every expert the same router logit, and expert e adds only its
    ``b_out`` row, the e-th unit vector (no dropout), or with dropout
    passes its first E middle units, each GELU(1), to the output
    columns."""
    ff = tnn.MoEFeedForward(E, FF, tnn.MoEConfig(
        n_experts=X, top_k=1, capacity_factor=4.0,
        router_noise=router_noise), p_dropout=p_dropout, device="cpu")
    with torch.no_grad():
        ff.router.normal_()
        if p_dropout:
            ff.b_in.fill_(1.0)
            ff.w_out.copy_(torch.eye(FF, E).expand(X, FF, E))
        else:
            ff.b_out.copy_(torch.eye(X, E))
    return ff


def test_router_noise_draws_from_the_generator():
    """Noise only in training with a generator: with equal logits the
    choice is then the noise's argmax, every expert about equally often;
    without it the first expert takes every token (the first index of a
    tie).  The same seed draws the same noise."""
    ff = probe_ff(router_noise=1.0)
    x = torch.zeros(1, 2000, E)
    with torch.no_grad():
        for kw in ({}, {"training": True},
                   {"generator": torch.Generator().manual_seed(0)}):
            y, _ = ff(x, **kw)
            assert (y.argmax(-1) == 0).all()
            torch.testing.assert_close(y[..., 0], torch.full((1, 2000), 0.25))
        noisy = [ff(x, training=True,
                    generator=torch.Generator().manual_seed(s))[0]
                 for s in (1, 1, 2)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    share = torch.bincount(noisy[0].argmax(-1).flatten(), minlength=X) / 2000
    assert (share - 1 / X).abs().max() < 0.05


def test_moe_dropout_draws_from_the_generator():
    """Dropout after the GELU: in training with a generator each middle
    unit is dropped with probability p and the kept ones scaled by 1/(1-p);
    otherwise none is dropped."""
    p = 0.3
    ff = probe_ff(p_dropout=p)
    x = torch.zeros(1, 4000, E)
    h = 0.25 * float(tnn.functional.gelu(torch.tensor(1.0)))   # gate 1/X
    with torch.no_grad():
        plain, _ = ff(x, training=True)
        torch.testing.assert_close(plain, torch.full((1, 4000, E), h))
        dropped, _ = ff(x, training=True,
                        generator=torch.Generator().manual_seed(0))
    cols = dropped
    zero = cols == 0
    assert abs(float(zero.float().mean()) - p) < 0.01
    torch.testing.assert_close(cols[~zero],
                               torch.full_like(cols[~zero], h / (1 - p)))


def model_pair(dtype="float32", seed=0, **over):
    cfg = {**CFG, **over}
    moe = cfg.pop("moe", MOE)
    jm = jnn.DecoderLM(jnn.DecoderConfig(
        **cfg, moe=JaxMoEConfig(**moe), dtype=getattr(jnp, dtype)))
    params = jax.jit(jm.init)(jax.random.key(seed))
    tm = tnn.DecoderLM(tnn.DecoderConfig(
        **cfg, moe=tnn.MoEConfig(**moe), dtype=getattr(torch, dtype)),
        device="cpu")
    tnn.load_jax_params(tm, params)
    return jm, params, tm


def test_moe_tree_round_trips_and_init_draws_the_jax_distributions():
    _, params, tm = model_pair()
    got = dict(tnn.named_tree_leaves(tnn.to_jax_params(tm)))
    want = dict(tnn.named_tree_leaves(params))
    assert got.keys() == want.keys()
    assert "position_embeddings" not in {n.split(".")[0] for n in got}
    for n in want:
        np.testing.assert_array_equal(got[n], np32(want[n]), err_msg=n)
    assert got["layers.0.ff.w_in"].shape == (X, E, FF)
    tnn.init_params(tm, torch.Generator().manual_seed(0))
    ff = tm.layers[0].ff
    for w, fan_in in ((ff.router, E), (ff.w_in, E), (ff.w_out, FF)):
        bound = 1.0 / np.sqrt(fan_in)
        assert 0.9 * bound < float(w.abs().max()) <= bound
    assert not ff.b_in.any() and not ff.b_out.any()


@pytest.mark.parametrize("kind,remat", [("flash", False), ("naive", False),
                                        ("fused", False), ("flash", True)])
def test_rope_moe_decoder_matches_jax(rng, kind, remat):
    """Logits, aux_total and every gradient of ``sum(logits * w) +
    aux_total`` on each attention route and under remat."""
    jm, params, tm = model_pair(attention_kind=kind, remat=remat)
    ids = rng.integers(0, CFG["n_vocab"], (2, 24))
    w = rng.standard_normal((2, 24, CFG["n_vocab"])).astype(np.float32)

    def objective(p):
        logits, aux = jm(p, jnp.asarray(ids), return_aux=True)
        return jnp.sum(logits * w) + aux, (logits, aux)

    (_, (logits_j, aux_j)), g_j = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    logits, aux = tm(torch.from_numpy(ids), return_aux=True)
    (torch.sum(logits * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(np32(logits), np32(logits_j), **F32)
    np.testing.assert_allclose(np32(aux), np32(aux_j), **F32)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    g_j = dict(tnn.named_tree_leaves(g_j))
    for n, p in tm.named_parameters():
        g = p.grad.T if n in linear else p.grad
        np.testing.assert_allclose(np32(g), np32(g_j[n]), err_msg=n, **F32)


def test_adam_step_on_the_aux_objective_matches_jax(rng):
    """One Adam step on ``mean CE + aux_weight * aux_total``: the loss and
    the updated parameters equal JAX's.  Adam's first step moves a weight
    by about lr * sign(g), so where |g| lies within 1e-6 of 0 (the K
    projection's bias, whose exact gradient is 0) a sign may differ and
    the two are held within 2 lr."""
    jm, params, tm = model_pair(attention_kind="naive")
    ids = rng.integers(0, CFG["n_vocab"], (2, 24))
    tgt = rng.integers(0, CFG["n_vocab"], (2, 24))
    lr, aux_weight = 1e-3, tm.cfg.moe.aux_weight

    def loss_fn(p):
        logits, aux = jm(p, jnp.asarray(ids), return_aux=True)
        ce = jnp.mean(jnn.functional.softmax_loss(logits, jnp.asarray(tgt)))
        return ce + aux_weight * aux

    loss_j, g_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    jopt = jnn.adam(lr=lr)
    new_j, _ = jax.jit(jopt.update)(g_j, jopt.init(params), params)
    logits, aux = tm(torch.from_numpy(ids), return_aux=True)
    loss = (tnn.functional.softmax_loss(logits, torch.from_numpy(tgt)).mean()
            + aux_weight * aux)
    loss.backward()
    params_t = dict(tm.named_parameters())
    topt = tnn.adam(lr=lr)
    new, _ = topt.update({n: p.grad for n, p in params_t.items()},
                         topt.init(params_t),
                         {n: p.detach() for n, p in params_t.items()})
    with torch.no_grad():
        for n, p in params_t.items():
            p.copy_(new[n])
    np.testing.assert_allclose(np32(loss), np32(loss_j), **F32)
    got = dict(tnn.named_tree_leaves(tnn.to_jax_params(tm)))
    g_j = dict(tnn.named_tree_leaves(g_j))
    for n, want in tnn.named_tree_leaves(new_j):
        near0 = np.abs(np32(g_j[n])) <= 1e-6
        diff = np.abs(got[n] - np32(want))
        assert (diff[~near0] <= 1e-6).all(), n
        assert (diff[near0] <= 2 * lr).all(), n


