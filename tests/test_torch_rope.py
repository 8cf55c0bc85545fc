"""The port's rotary positions and one-hot embedding against the JAX
package's, and the rotary + MoE decoder's cached decode and serving, with
the same JAX-initialized parameters (``load_jax_params``) and inputs from a
numpy seed:

* ``apply_rope``: fp32 within 1e-6, bf16 within one bf16 ulp, at
  positions up to 5,000; ``one_hot`` and ``embedding_one_hot``'s logits
  equal to the gather's and to JAX's;
* ``DecoderLM(positional="rope", moe=...)``: cached decode (a prefill, then
  a token a step) against JAX's and, where no token is dropped, against
  the full forward (JAX ``tests/test_rope.py:60``);
* greedy serving of that model through ``generate``, ``beam_generate``,
  ``speculative_generate`` (a learned draft) and ``DecodeEngine`` (``run``,
  chunked prefill with ``set_prefix``, ``run_speculative``) gives JAX's
  tokens with ``max_len`` past ``n_positions``: a rotary model has no
  table, and its positions are clamped nowhere, as in JAX; a learned model
  keeps its own clamp in the engine.

With MoE a row's output depends on the whole call (the capacity counts
every token of it, and tokens compete for the slots in order), so every
comparison runs the same batch through both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import SamplingConfig as JaxSampling
from tpu_flash.inference import beam_generate as jax_beam
from tpu_flash.inference import generate as jax_generate
from tpu_flash.inference import sampler as jsampler
from tpu_flash.inference import speculative_generate as jax_speculative
from tpu_flash.inference.engine import DecodeEngine as JaxEngine
from tpu_flash.inference.engine import Request as JaxRequest
from tpu_flash.nn import functional as JF
from tpu_flash.nn.moe import MoEConfig as JaxMoEConfig
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import (DecodeEngine, Request, SamplingConfig,
                                       beam_generate, generate,
                                       speculative_generate)
from tpu_flash_torch.inference import sampler as tsampler
from tpu_flash_torch.inference.speculative import _positions
from tpu_flash_torch.nn import functional as TF

torch.set_num_threads(1)

MOE = dict(n_experts=4, top_k=2, capacity_factor=1.25)
# the rotary + MoE decoder; n_positions far below the serving max_len
CFG = dict(n_vocab=64, n_embd=32, n_head=4, n_positions=4, n_layer=2,
           ff_middle_dim=48, p_dropout=0.0, positional="rope")
DRAFT = dict(n_vocab=64, n_embd=16, n_head=2, n_positions=40, n_layer=1,
             ff_middle_dim=32, p_dropout=0.0, attention_kind="naive")
LENS = [3, 9, 5, 12]
N_NEW, MAX_LEN = 12, 40
F32 = dict(atol=1e-5, rtol=1e-5)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(rng, dtype):
    x = rng.standard_normal((2, 3, 64, 16)).astype(np.float32)
    pos = np.stack([np.arange(64), 5000 + 7 * np.arange(64)])
    want = np32(jax.jit(JF.apply_rope)(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos, jnp.int32)))
    got = TF.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(np32(got), want, atol=1e-6, rtol=0)
    else:           # one ulp: 2^-7 of the value's power of two
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  1e-30))) - 7)
        assert (np.abs(np32(got) - want) <= ulp).all()


def test_one_hot_matches_jax():
    ids = np.asarray([[0, 3, 9, -1], [10, 11, 2, 5]])
    want = np.asarray(JF.one_hot(jnp.asarray(ids), 10))
    got = TF.one_hot(torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(np32(got), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_one_hot_matches_the_gather_and_jax(rng, dtype):
    """The one-hot product picks each row exactly, so the logits equal the
    gather model's; and JAX's one-hot model's (fp32 within 1e-5)."""
    cfg = dict(n_vocab=64, n_embd=32, n_head=4, n_positions=32, n_layer=2,
               ff_middle_dim=48, p_dropout=0.0, attention_kind="naive")
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg, embedding_one_hot=True,
                                         dtype=getattr(jnp, dtype)))
    params = jax.jit(jm.init)(jax.random.key(0))
    models = {}
    for one_hot in (True, False):
        models[one_hot] = tnn.DecoderLM(tnn.DecoderConfig(
            **cfg, embedding_one_hot=one_hot, dtype=getattr(torch, dtype)),
            device="cpu")
        tnn.load_jax_params(models[one_hot], params)
    ids = rng.integers(0, 64, (2, 20))
    with torch.no_grad():
        got = models[True](torch.from_numpy(ids))
        torch.testing.assert_close(got, models[False](torch.from_numpy(ids)),
                                   rtol=0, atol=0)
    if dtype == "float32":
        want = jax.jit(jm)(params, jnp.asarray(ids))
        np.testing.assert_allclose(np32(got), np32(want), **F32)


def model_pair(seed=0, **over):
    cfg = {**CFG, **over}
    moe = cfg.pop("moe", MOE)
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg, moe=JaxMoEConfig(**moe)))
    params = jax.jit(jm.init)(jax.random.key(seed))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**cfg, moe=tnn.MoEConfig(**moe)),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    return jm, params, tm


def test_rope_moe_cached_decode_matches_jax_and_the_full_forward(rng):
    """A 4-token prefill, then one token a step at the cache's lengths: the
    logits and aux equal JAX's at each step (capacity 1.25, tokens
    dropped); at capacity 4.0 nothing is dropped, so each step's logits
    equal the full forward's (JAX tests/test_rope.py:60)."""
    B, L = 2, 12
    ids = rng.integers(0, CFG["n_vocab"], (B, L))
    for moe in (MOE, {**MOE, "capacity_factor": 4.0}):
        jm, params, tm = model_pair(moe=moe)
        fwd = jax.jit(lambda p, x, c, pos: jm(p, x, kv_caches=c,
                                              positions=pos,
                                              return_aux=True))
        full = tm(torch.from_numpy(ids))
        jc = jsampler.make_caches(jm, B, 32)
        tc = tsampler.make_caches(tm, B, 32)
        for t0, t1 in [(0, 4)] + [(t, t + 1) for t in range(4, L)]:
            pos = np.arange(t0, t1)[None].repeat(B, 0)
            want, jc, aux_j = fwd(params, jnp.asarray(ids[:, t0:t1]), jc,
                                  jnp.asarray(pos))
            with torch.no_grad():
                got, tc, aux = tm(torch.from_numpy(ids[:, t0:t1]),
                                  kv_caches=tc, positions=torch.from_numpy(
                                      pos), return_aux=True)
            np.testing.assert_allclose(np32(got), np32(want),
                                       err_msg=f"step {t0}", **F32)
            np.testing.assert_allclose(np32(aux), np32(aux_j), **F32)
            if moe["capacity_factor"] == 4.0:
                np.testing.assert_allclose(np32(got), np32(full[:, t0:t1]),
                                           atol=1e-4, rtol=1e-4)


def test_clamp_only_where_there_is_a_table():
    """The engine's positions are clamped to a learned model's table (its
    idle slots count past it) and never for a rotary model, per model."""
    lengths = torch.tensor([3, 39])
    learned = tnn.DecoderLM(tnn.DecoderConfig(**{**DRAFT,
                                                 "n_positions": 16}),
                            device="cpu")
    rope = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    assert _positions(lengths, 2, learned, True).tolist() == [[3, 4],
                                                              [15, 15]]
    assert _positions(lengths, 2, rope, True).tolist() == [[3, 4], [39, 40]]
    assert _positions(lengths, 2, learned, False).tolist() == [[3, 4],
                                                               [39, 40]]


@pytest.fixture(scope="module")
def served():
    """The rotary + MoE target (n_positions 4, a max_len of 40), a learned
    dense draft, prompts from a seed.  The target's q and k projections are
    scaled by 4 in both packages, so that its attention is sharp enough
    for a position rotated wrongly (one clamped to the table) to change
    greedy tokens."""
    jm, params, tm = model_pair(seed=3, attention_kind="flash")
    for layer in params["layers"].values():
        for n in ("q_projection", "k_projection"):
            layer["attention"][n]["weight"] *= 4.0
    tnn.load_jax_params(tm, params)
    jd = jnn.DecoderLM(jnn.DecoderConfig(**DRAFT))
    dparams = jax.jit(jd.init)(jax.random.key(5))
    td = tnn.DecoderLM(tnn.DecoderConfig(**DRAFT), device="cpu")
    tnn.load_jax_params(td, dparams)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG["n_vocab"], n).tolist() for n in LENS]
    ids = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return dict(jm=jm, params=params, model=tm, jd=jd, dparams=dparams,
                draft=td, prompts=prompts, ids=ids)


def test_rope_moe_generate_beam_and_speculative_match_jax(served):
    """Greedy ``generate``, beam search (width 3) and speculative decoding
    (the learned draft, n_draft 3) give JAX's tokens and lengths, past
    ``n_positions``."""
    s = served
    jm, params, ids, lens = s["jm"], s["params"], s["ids"], np.asarray(LENS)
    sampling = SamplingConfig(max_new_tokens=N_NEW)
    runs = {
        "generate": (
            lambda: jax.jit(functools.partial(
                jax_generate, jm, sampling=JaxSampling(max_new_tokens=N_NEW),
                max_len=MAX_LEN))(params, jnp.asarray(ids),
                                  jnp.asarray(lens)),
            lambda: generate(s["model"], ids, lens, sampling,
                             max_len=MAX_LEN, device="cpu")),
        "beam": (
            lambda: jax.jit(functools.partial(
                jax_beam, jm, beam_size=3, max_new_tokens=N_NEW,
                max_len=MAX_LEN, eos_id=-1))(
                    params, jnp.asarray(ids), jnp.asarray(lens)),
            lambda: beam_generate(s["model"], ids, lens, beam_size=3,
                                  max_new_tokens=N_NEW, max_len=MAX_LEN,
                                  eos_id=-1, device="cpu")),
        "speculative": (
            lambda: jax.jit(lambda p, dp, i, n: jax_speculative(
                jm, p, s["jd"], dp, i, n, JaxSampling(max_new_tokens=N_NEW),
                max_len=MAX_LEN, n_draft=3))(
                    params, s["dparams"], jnp.asarray(ids),
                    jnp.asarray(lens)),
            lambda: speculative_generate(
                s["model"], s["draft"], ids, lens, sampling,
                max_len=MAX_LEN, n_draft=3, device="cpu")),
    }
    for what, (jax_run, port_run) in runs.items():
        want_t, want_n = (np.asarray(a) for a in jax_run())
        got_t, got_n = port_run()
        np.testing.assert_array_equal(got_t.numpy(), want_t, err_msg=what)
        np.testing.assert_array_equal(got_n.numpy(), want_n, err_msg=what)


def completions(done):
    return {c.uid: (c.tokens, c.finished_reason) for c in done}


@pytest.mark.parametrize("mode", ["run", "prefix", "speculative"])
def test_rope_moe_engine_matches_jax(served, mode):
    """The engine over 2 slots (the idle slot's row counts in the
    capacity, as in JAX): bucketed prefill and ``run()``; chunked prefill
    (chunk 4) with a shared 5-token prefix (``set_prefix``); and
    ``run_speculative`` with the learned draft, every round speculative.
    The sequences run to 24 tokens, past the 4 of ``n_positions``."""
    s = served
    prefix = s["prompts"][3][:5]
    prompts = (s["prompts"] if mode != "prefix" else
               [prefix + p for p in s["prompts"]])
    kw = dict(n_slots=2, max_len=MAX_LEN)
    if mode == "prefix":
        kw["prefill_chunk"] = 4
    jkw, tkw = dict(kw), dict(kw)
    if mode == "speculative":
        jkw.update(draft_model=s["jd"], draft_params=s["dparams"], n_draft=3)
        tkw.update(draft_model=s["draft"], n_draft=3)
    jeng = JaxEngine(s["jm"], s["params"], **jkw,
                     sampling=JaxSampling(max_new_tokens=N_NEW))
    eng = DecodeEngine(s["model"], **tkw, device="cpu",
                       sampling=SamplingConfig(max_new_tokens=N_NEW))
    if mode == "prefix":
        jeng.set_prefix(prefix)
        eng.set_prefix(prefix)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid, p))
        eng.submit(Request(uid, p))
    if mode == "speculative":
        want = completions(jeng.run_speculative(probe_rounds=None))
        got = completions(eng.run_speculative(probe_rounds=None))
    else:
        want, got = completions(jeng.run()), completions(eng.run())
    assert got == want
    assert min(len(p) + len(want[u][0])
               for u, p in enumerate(prompts)) > CFG["n_positions"]
