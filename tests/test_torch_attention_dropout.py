"""Attention dropout in the port against the JAX package, on the CPU.

The port's hash (``kernels.flash_attention.dropout_keep_mask``) against
JAX's ``dropout_keep_mask`` bit for bit, over indices near 2**31 and
negative seeds; ``ops.reference.dropout_keep_oracle`` against JAX's, seed
offsets included; the flash kernels' plain versions under dropout against
JAX's ``flash_attention_forward`` / ``_backward`` (Pallas in interpret
mode, as its own tests run it) at one shape below d = 128 in fp32 and in
bf16, where the normaliser must sum the undropped fp32 P (``_fold_l`` off),
and against the JAX op's dense ``impl="xla"`` form elsewhere, alone and
composed with a window and packed segments, forward 1e-3 and backward 1e-2
(1e-5 in fp32); ``DecoderLM`` with ``attn_dropout=0.3`` on the flash, naive
and fused routes against the JAX model with the same parameters
(``load_jax_params``) and the same seeds at 1e-5; the JAX package's
rate-0 identity, determinism, drop-fraction, mean-preserving and
central-difference cases; the op's gradients against autograd through
dense attention with the same mask; remat drawing the same seed in its recompute; and what still
raises.  Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_flash
from tpu_flash import nn as jnn
from tpu_flash.kernels import flash_attention as jfa
from tpu_flash.ops import reference as jref
from tpu_flash_torch import nn as tnn
from tpu_flash_torch import ops as tops
from tpu_flash_torch.kernels import flash_attention as tfa
from tpu_flash_torch.nn import transformer as ttr

torch.set_num_threads(1)

FW_TOL = dict(atol=1e-3, rtol=1e-3)
BW_TOL = dict(atol=1e-2, rtol=1e-3)
F32 = dict(atol=1e-5, rtol=1e-5)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def packed_ids(rng, B, L):
    """Segment ids [B, L]: runs of 1 to 20 positions."""
    rows = []
    for _ in range(B):
        ids, sid = [], 0
        while len(ids) < L:
            ids += [sid] * int(rng.integers(1, 21))
            sid += 1
        rows.append(ids[:L])
    return np.asarray(rows, np.int32)


# --- the hash and the oracle ---------------------------------------------------

INDICES = np.array([0, 1, 2, 63, 64, 1000, 123457, 2 ** 30, 2 ** 31 - 2,
                    2 ** 31 - 1], np.int32)


@pytest.mark.parametrize("seed", [0, 1234, -1, -987654321, -2 ** 31,
                                  2 ** 31 - 1])
def test_keep_mask_equals_jax_bit_for_bit(seed):
    rows, cols = INDICES[:, None], INDICES[None, ::-1].copy()
    for b, h, rate in ((0, 0, 0.1), (3, 7, 0.25), (2 ** 31 - 1, -5, 0.5),
                       (-2 ** 31, 2 ** 30, 0.9)):
        want = np.asarray(jfa.dropout_keep_mask(
            jnp.asarray(rows), jnp.asarray(cols), jnp.int32(b), jnp.int32(h),
            jnp.int32(seed), rate))
        got = tfa.dropout_keep_mask(torch.from_numpy(rows),
                                    torch.from_numpy(cols), b, h, seed, rate)
        np.testing.assert_array_equal(got.numpy(), want)
        # the same bits with every index a tensor
        got_t = tfa.dropout_keep_mask(
            torch.from_numpy(rows), torch.from_numpy(cols),
            torch.tensor(b, dtype=torch.int32),
            torch.tensor(h, dtype=torch.int32),
            torch.tensor(seed, dtype=torch.int32), rate)
        np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("seed", [42, -7, [5, 2, 3], [-11, 0, 1]])
def test_keep_oracle_equals_jax(seed):
    """The dense multiplier, [seed, batch offset, head offset] included;
    an int seed and its one-value tensor give the same multiplier."""
    B, H, Lq, Lk, rate = 2, 3, 40, 56, 0.25
    want = np.asarray(jref.dropout_keep_oracle(
        B, H, Lq, Lk, jnp.asarray(seed, jnp.int32), rate))
    tseed = (torch.tensor(seed, dtype=torch.int32)
             if isinstance(seed, list) else seed)
    got = tops.dropout_keep_oracle(B, H, Lq, Lk, tseed, rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if not isinstance(seed, list):
        np.testing.assert_array_equal(
            tops.dropout_keep_oracle(B, H, Lq, Lk,
                                     torch.tensor([seed]), rate).numpy(),
            want)
    # a block of rows at a time gives the same multiplier
    drop = tfa.Dropout(tfa.dropout_seed_array(tseed, torch.device("cpu")),
                       rate)
    blocks = torch.cat([k for _, k in tfa.dropout_keep_blocks(
        B, H, Lq, Lk, drop, rows_per_block=7)], dim=2)
    np.testing.assert_array_equal(blocks.numpy(), want)


def test_drop_fraction():
    keep = tops.dropout_keep_oracle(2, 2, 256, 256, 42, 0.25)
    assert abs(float((keep == 0).float().mean()) - 0.25) < 0.01
    assert np.isclose(float(keep.max()), 1.0 / 0.75, rtol=1e-6)


# --- the plain kernels against JAX ----------------------------------------------

def test_plain_matches_jax_kernels_in_interpret_mode(rng):
    """fp32 at B1 H2 L128 d32 (GQA 2:1): the forward and both backward
    forms against the JAX Pallas kernels with the same seed."""
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((1, 2, 128, 32), (1, 1, 128, 32), (1, 1, 128, 32),
               (1, 2, 128, 32))]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=True, dropout_rate=0.2, dropout_seed=-77)
    jout, jlse, _ = jfa.flash_attention_forward(jq, jk, jv, **kw)
    out, lse, _ = tfa.flash_attention_forward(q, k, v, **kw)
    np.testing.assert_allclose(np32(out), np32(jout), **FW_TOL)
    np.testing.assert_allclose(np32(lse), np32(jlse), **FW_TOL)
    want = jfa.flash_attention_backward(jq, jk, jv, jout, jlse, jdo, **kw)
    for got in (tfa.flash_attention_backward_fused(q, k, v, out, lse, do,
                                                   **kw),
                tfa.flash_attention_backward_two_pass(q, k, v, out, lse, do,
                                                      **kw)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), **BW_TOL)


def test_bf16_forward_normaliser_sums_undropped_fp32_p(rng):
    """bf16 at d = 64, below the JAX rule's fold_l limit: under dropout the
    JAX forward's normaliser sums the undropped fp32 P (fold_l off), so the
    port's lse sits within 2e-4 of JAX's (the bf16 P's sum is ~1e-3 away)
    and out within 2e-3."""
    arrays = [rng.standard_normal((1, 2, 192, 64)).astype(np.float32)
              for _ in range(3)]
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=9)
    jout, jlse, _ = jfa.flash_attention_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), **kw)
    out, lse, _ = tfa.flash_attention_forward(
        *(torch.from_numpy(a).bfloat16() for a in arrays), **kw)
    np.testing.assert_allclose(np32(lse), np32(jlse), atol=2e-4, rtol=0)
    np.testing.assert_allclose(np32(out), np32(jout.astype(jnp.float32)),
                               atol=2e-3, rtol=0)
    folded, _, _ = tfa.flash_attention_forward(
        *(torch.from_numpy(a).bfloat16() for a in arrays), causal=True)
    assert float((folded.float() - out.float()).abs().max()) > 0


# B, H, Hkv, Lq, Lk, d, causal, window, segmented
XLA_CASES = [
    (2, 2, 2, 64, 64, 16, False, None, False),
    (1, 4, 2, 96, 96, 32, True, None, False),
    (1, 2, 2, 48, 112, 32, True, None, False),       # Lq < Lk
    (1, 2, 1, 128, 128, 64, True, 24, False),
    (2, 2, 2, 80, 80, 32, True, None, True),
    (1, 2, 1, 100, 100, 16, True, 17, True),
]


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,causal,window,segmented",
                         XLA_CASES)
def test_plain_matches_the_jax_dense_form(rng, B, H, Hkv, Lq, Lk, d, causal,
                                          window, segmented):
    """The plain forward and both backward forms against the JAX op's
    ``impl="xla"`` (dense softmax times the same oracle, differentiated
    by jax.vjp) in fp32 at 1e-5."""
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, Lq, d), (B, Hkv, Lk, d), (B, Hkv, Lk, d),
               (B, H, Lq, d))]
    seg = packed_ids(rng, B, Lq) if segmented else None
    rate, seed = 0.3, 2024 - Lq
    jkw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed,
               window=window,
               segment_ids=None if seg is None else jnp.asarray(seg))

    @jax.jit
    def dense(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: tpu_flash.flash_attention(
            a, b, c, impl="xla", **jkw), q, k, v)
        return out, vjp(do)

    jout, want = dense(*(jnp.asarray(a) for a in arrays))
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = {**jkw, "segment_ids": None if seg is None
          else torch.from_numpy(seg)}
    out, lse, _ = tfa.flash_attention_forward(q, k, v, **kw)
    np.testing.assert_allclose(np32(out), np32(jout), **F32)
    for form in (tfa.flash_attention_backward_fused,
                 tfa.flash_attention_backward_two_pass):
        for g, w in zip(form(q, k, v, out, lse, do, **kw), want):
            np.testing.assert_allclose(np32(g), np32(w), **F32)


def test_rate_zero_is_identity(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 64, 32))
                                .astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, causal=True, dropout_rate=0.0,
                             dropout_seed=7),
        tops.flash_attention(q, k, v, causal=True), rtol=0, atol=0)


def test_deterministic_and_seed_sensitive(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 96, 32))
                                .astype(np.float32)) for _ in range(3))
    a = tops.flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=5)
    b = tops.flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=5)
    c = tops.flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 0
    # an int seed, its tensor and the [seed, 0, 0] array give the same
    # output; a head offset moves the mask
    for s in (torch.tensor(5), torch.tensor([5, 0, 0], dtype=torch.int32)):
        torch.testing.assert_close(
            tops.flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=s),
            a, rtol=0, atol=0)
    shifted = tops.flash_attention(q, k, v, dropout_rate=0.3,
                                   dropout_seed=torch.tensor([5, 0, 1]))
    assert float((shifted - a).abs().max()) > 0


def test_mean_preserving():
    """E[dropout(P)] = P: averaged over many rows, out stays near the
    undropped out."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 4, 128, 32))
                                .astype(np.float32) * 0.5)
               for _ in range(3))
    drop = tops.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=9)
    base = tops.flash_attention(q, k, v)
    assert float((drop - base).abs().mean()) < 0.5 * float(base.abs().mean())


@pytest.mark.parametrize("causal", [False, True])
def test_op_gradients_match_dense_autograd(rng, causal):
    """The autograd Function under dropout (GQA, the plain versions)
    against autograd through dense attention times the same oracle."""
    B, H, Hkv, L, d, rate, seed = 1, 4, 2, 80, 32, 0.15, 3
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, H, L, d), (B, Hkv, L, d), (B, Hkv, L, d),
                             (B, H, L, d)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal, dropout_rate=rate,
                               dropout_seed=seed)
    grads = torch.autograd.grad((out * do).sum(), leaves)
    dense = [x.clone().requires_grad_() for x in (q, k, v)]
    kk, vv = (x.repeat_interleave(H // Hkv, 1) for x in dense[1:])
    s = dense[0] @ kk.transpose(-1, -2) / d ** 0.5
    if causal:
        s = s + tops.causal_mask(L, L)
    p = torch.softmax(s, -1) * tops.dropout_keep_oracle(B, H, L, L, seed,
                                                        rate)
    ref = p @ vv
    ref_grads = torch.autograd.grad((ref * do).sum(), dense)
    torch.testing.assert_close(out, ref, **F32)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_central_difference(rng, causal):
    """The regenerated-mask backward against central differences of the
    dropped forward (the mask is a function of the seed, so the dropped
    objective is differentiable), at three positions of each input: the
    JAX package's ``grad_check`` case (eps 1e-3, rtol and atol 2e-2)."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 96, 64))
                                .astype(np.float32) * 0.5) for _ in range(3))

    def fn(q, k, v):
        return tops.flash_attention(q, k, v, causal=causal,
                                    dropout_rate=0.2,
                                    dropout_seed=11).sum()

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(fn(*leaves), leaves)
    pick = np.random.default_rng(0)
    for i, (x, g) in enumerate(zip((q, k, v), grads)):
        for flat in pick.choice(x.numel(), size=3, replace=False):
            idx = np.unravel_index(int(flat), tuple(x.shape))
            up, down = x.clone(), x.clone()
            up[idx] += 1e-3
            down[idx] -= 1e-3
            args = [up if j == i else y for j, y in enumerate((q, k, v))]
            f_up = fn(*args)
            args[i] = down
            numeric = (f_up - fn(*args)) / 2e-3
            np.testing.assert_allclose(float(g[idx]), float(numeric),
                                       rtol=2e-2, atol=2e-2)


def test_what_raises(rng):
    """Dropout's refusals; quantized K/V is ported and composes with
    dropout (the op, the kernels' entries given codes, the config), its
    entries refusing float K/V with scales and a k_scale alone."""
    q = torch.zeros(1, 2, 16, 16)
    out = tops.flash_attention(q, q, q, kv_quant="int8", dropout_rate=0.1)
    assert torch.isfinite(out).all()
    with pytest.raises(TypeError, match="codes"):
        tfa.flash_attention_forward(q, q, q, dropout_rate=0.1,
                                    k_scale=torch.ones(1), v_scale=torch.ones(1))
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention_forward(q, q.to(torch.int8), q.to(torch.int8),
                                    dropout_rate=0.1, k_scale=torch.ones(1))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout_rate"):
            tops.flash_attention(q, q, q, dropout_rate=rate)
    with pytest.raises(ValueError, match="1 to 3"):
        tops.flash_attention(q, q, q, dropout_rate=0.1,
                             dropout_seed=torch.zeros(4, dtype=torch.int32))
    assert tnn.DecoderConfig(attn_dropout=0.1, kv_quant="int8").kv_quant \
        == "int8"


# --- the model ------------------------------------------------------------------

CFG = dict(n_vocab=64, n_embd=32, n_head=2, n_positions=32, n_layer=2,
           ff_middle_dim=64, p_dropout=0.0, attn_dropout=0.3)
SEEDS = (1357, 2 ** 31 - 2)     # one a layer, as the JAX model draws them


@pytest.mark.parametrize("kind", ["flash", "naive", "fused"])
def test_model_matches_jax_with_the_same_seeds(rng, monkeypatch, kind):
    """Training forwards of the JAX model and the port with the same
    parameters, each layer's attention seed the same (JAX's randint and
    the port's ``attention_seed`` replaced by one list of seeds): logits
    at 1e-5 in fp32, and other than the eval forward's."""
    over = dict(attention_kind=kind, use_fused_kernel=kind == "fused")
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, **over))
    params = jm.init(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, **over), device="cpu")
    tnn.load_jax_params(tm, params)
    ids = rng.integers(0, CFG["n_vocab"], (2, 24))
    jseeds, tseeds = list(SEEDS), list(SEEDS)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.int32(jseeds.pop(0)))
    monkeypatch.setattr(ttr, "attention_seed", lambda gen: torch.tensor(
        [tseeds.pop(0)], dtype=torch.int32))
    want = jax.jit(lambda p, x, key: jm(p, x, key=key, training=True))(
        params, jnp.asarray(ids, jnp.int32), jax.random.key(1))
    got = tm(torch.from_numpy(ids), training=True,
             generator=torch.Generator().manual_seed(0))
    assert not jseeds and not tseeds
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    evaluated = tm(torch.from_numpy(ids))
    assert float((got - evaluated).detach().abs().max()) > 0


@pytest.mark.parametrize("kind", ["flash", "naive", "fused"])
def test_model_level_attn_dropout(rng, kind):
    """The JAX package's case: attention dropout changes the training
    forward on every route (the same generator seed gives the same logits,
    another seed others) and not the eval forward."""
    cfg = tnn.DecoderConfig(n_vocab=64, n_embd=32, n_head=2, n_layer=1,
                            p_dropout=0.0, attn_dropout=0.3,
                            attention_kind=kind,
                            use_fused_kernel=kind == "fused")
    model = tnn.DecoderLM(cfg, device="cpu")
    tnn.init_params(model, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(rng.integers(0, 64, (2, 16)))

    def train(seed):
        return model(ids, training=True,
                     generator=torch.Generator().manual_seed(seed))

    a, b, c = train(1), train(1), train(2)
    e = model(ids)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(e, model(ids), rtol=0, atol=0)
    assert float((a - c).detach().abs().max()) > 0
    assert float((a - e).detach().abs().max()) > 0
    # no generator: no dropout, as the JAX model without a key
    torch.testing.assert_close(model(ids, training=True), e, rtol=0, atol=0)


def test_remat_recompute_draws_the_same_attention_seed(rng):
    """remat on and off give the same loss and gradients bit for bit with
    attention dropout from one seeded generator: the recompute draws the
    forward's seeds."""
    ids = torch.from_numpy(rng.integers(0, 64, (2, 32)))
    results = []
    for remat in (False, True):
        cfg = tnn.DecoderConfig(**{**CFG, "p_dropout": 0.1}, remat=remat)
        model = tnn.DecoderLM(cfg, device="cpu")
        tnn.init_params(model, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(4)
        loss = model(ids, training=True, generator=gen).square().mean()
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()],
                        gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    torch.testing.assert_close(l0, l1, rtol=0, atol=0)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(s0, s1)
