"""The port's ``beam_generate`` against the JAX package's: the same tokens
and lengths on the same JAX-initialized parameters and prompts from a numpy
seed, over fp32 and int8 caches, with an eos, and past the position table
(where both embed NaN and the stable sort takes NaN first, as
``jax.lax.top_k`` does).

Before a comparison inside the table, the fixture replays the search in
float64 over the JAX model's uncached logits and checks that every choice
is far from a tie: the W-th kept candidate beats the first dropped one, and
the chosen beam's normalised score beats the next, by more than 1e-4 (the
two frameworks' logits agree to 1e-5 in fp32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import beam_generate as jax_beam
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import SamplingConfig, beam_generate, generate

torch.set_num_threads(1)

CFG = dict(n_vocab=64, n_embd=32, n_head=4, n_positions=40, n_layer=2,
           ff_middle_dim=64, p_dropout=0.0, attention_kind="naive")
LENS = [3, 7, 2]
N_NEW, MAX_LEN = 6, 32
PAD = 0


@pytest.fixture(scope="module")
def ref():
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, CFG["n_vocab"], n).tolist() for n in LENS]
    ids = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    forward = jax.jit(lambda p, x: jm(p, x))
    return dict(jm=jm, params=params, model=tm, prompts=prompts, ids=ids,
                logits=lambda x: np.asarray(forward(params, jnp.asarray(x)),
                                            np.float64))


def jax_tokens(ref, W, quant="none", eos=-1, n_new=N_NEW, max_len=MAX_LEN):
    run = jax.jit(functools.partial(
        jax_beam, ref["jm"], beam_size=W, max_new_tokens=n_new,
        max_len=max_len, eos_id=eos, pad_id=PAD, kv_quant=quant))
    toks, n = run(ref["params"], jnp.asarray(ref["ids"]),
                  jnp.asarray(LENS))
    return np.asarray(toks), np.asarray(n)


def assert_no_near_ties(ref, W, eos=-1, n_new=N_NEW, lp=0.6, gap=1e-4):
    """GNMT beam search in float64 over the JAX model's uncached logits:
    every step's W-th kept candidate above the first dropped one, and the
    final choice above the runner-up, by more than ``gap``.  Returns the
    replay's (tokens, lengths) of the best beams."""
    B, V = len(LENS), CFG["n_vocab"]
    scores = np.full((B, W), -1e30)
    scores[:, 0] = 0.0
    done = np.zeros((B, W), bool)
    gen_len = np.zeros((B, W), np.int64)
    out = np.full((B, W, n_new), PAD, np.int64)
    finished = np.full(V, -1e30)
    finished[PAD] = 0.0
    for step in range(n_new):
        # padded to 4 beams and N_NEW steps: one compile of the forward
        seqs = np.zeros((B * 4, max(LENS) + max(n_new, N_NEW)), np.int32)
        for b, p in enumerate(ref["prompts"]):
            for w in range(W):
                seqs[b * W + w, :len(p) + step] = p + out[b, w, :step].tolist()
        logits = ref["logits"](seqs)
        for b, n in enumerate(LENS):
            x = logits[b * W:(b + 1) * W, n - 1 + step]
            logp = x - x.max(-1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
            logp = np.where(done[b][:, None], finished, logp)
            cand = (scores[b][:, None] + logp).reshape(-1)
            order = np.argsort(-cand, kind="stable")
            if cand[order[W]] > -1e29:
                assert cand[order[W - 1]] - cand[order[W]] > gap, (b, step)
            parent, token = order[:W] // V, order[:W] % V
            was = done[b][parent]
            out[b] = out[b][parent]
            out[b, :, step] = np.where(was, PAD, token)
            gen_len[b] = gen_len[b][parent] + ~was
            done[b] = was | (token == eos)
            scores[b] = cand[order[:W]]
        if done.all():
            break
    adj = scores / np.maximum(((5.0 + gen_len) / 6.0) ** lp, 1e-6)
    adj = np.where(done.any(1, keepdims=True) & ~done, -1e30, adj)
    top2 = np.sort(adj, axis=1)[:, -2:]
    if W > 1:
        assert ((top2[:, 1] - top2[:, 0]) > gap).all(), adj
    best = adj.argmax(1)
    return out[np.arange(B), best], gen_len[np.arange(B), best]


@pytest.mark.parametrize("W,quant,with_eos", [(1, "none", False),
                                              (3, "none", True),
                                              (4, "int8", False)])
def test_beam_matches_jax(ref, W, quant, with_eos):
    """Beam 1 is greedy decoding.  ``with_eos``: eos is the second token of
    prompt 0's search without one, so that sequence ends in eos with pads
    after it."""
    eos = int(assert_no_near_ties(ref, W)[0][0, 1]) if with_eos else -1
    want, want_n = jax_tokens(ref, W, quant, eos=eos)
    if quant == "none":
        replay, replay_n = assert_no_near_ties(ref, W, eos=eos)
        np.testing.assert_array_equal(replay, want)
        np.testing.assert_array_equal(replay_n, want_n)
    toks, n = beam_generate(ref["model"], ref["ids"], LENS, beam_size=W,
                            max_new_tokens=N_NEW, max_len=MAX_LEN,
                            eos_id=eos, pad_id=PAD, kv_quant=quant,
                            device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want)
    np.testing.assert_array_equal(n.numpy(), want_n)
    if with_eos:
        row, k = toks[0].tolist(), int(n[0])
        assert k < N_NEW and row[k - 1] == eos
        assert all(t == PAD for t in row[k:])
    if W == 1:
        greedy, _ = generate(ref["model"], ref["ids"], LENS,
                             SamplingConfig(max_new_tokens=N_NEW),
                             max_len=MAX_LEN, kv_quant=quant, device="cpu")
        np.testing.assert_array_equal(toks.numpy(), greedy.numpy())


def test_beam_past_the_position_table(ref):
    """The MT app's call: ``max_len`` = prompt + ``max_new`` with
    ``max_new`` the table's length (40), so the last steps embed positions
    past the table as NaN in both packages."""
    n_new = CFG["n_positions"]
    max_len = max(LENS) + n_new
    assert max_len > CFG["n_positions"]
    want, want_n = jax_tokens(ref, 3, n_new=n_new, max_len=max_len)
    toks, n = beam_generate(ref["model"], ref["ids"], LENS, beam_size=3,
                            max_new_tokens=n_new, max_len=max_len,
                            eos_id=-1, pad_id=PAD, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want)
    np.testing.assert_array_equal(n.numpy(), want_n)


def test_beam_scores_at_least_greedy(ref):
    """Beam 4 without length normalisation finds a sequence whose log-prob
    under the model is at least greedy's (JAX's own property test)."""
    model = ref["model"]

    def logprob(prompt, toks):
        ids = torch.tensor([prompt + toks])
        with torch.no_grad():
            lp = torch.log_softmax(model(ids)[0].double(), -1)
        return sum(float(lp[len(prompt) - 1 + i, t])
                   for i, t in enumerate(toks))

    greedy, _ = generate(model, ref["ids"], LENS,
                         SamplingConfig(max_new_tokens=N_NEW),
                         max_len=MAX_LEN, device="cpu")
    beam, _ = beam_generate(model, ref["ids"], LENS, beam_size=4,
                            max_new_tokens=N_NEW, max_len=MAX_LEN, eos_id=-1,
                            length_penalty=0.0, device="cpu")
    for i, p in enumerate(ref["prompts"]):
        assert (logprob(p, beam[i].tolist())
                >= logprob(p, greedy[i].tolist()) - 1e-6)


def test_beam_trace_records_each_choice(ref):
    """``trace`` holds a step's scores and finished flags before it and the
    flat indices it keeps: one entry a step, the first step from beam 0
    alone, each next entry's scores in descending order, and the returned
    row a kept path traced back through the parents."""
    W, V = 3, CFG["n_vocab"]
    trace = []
    toks, _ = beam_generate(ref["model"], ref["ids"], LENS, beam_size=W,
                            max_new_tokens=N_NEW, max_len=MAX_LEN,
                            eos_id=-1, pad_id=PAD, device="cpu",
                            trace=trace)
    assert len(trace) == N_NEW
    scores, done, kept = trace[0]
    assert (scores[:, 0] == 0).all() and (scores[:, 1:] < -1e29).all()
    assert not done.any() and (kept // V == 0).all()
    for (_, _, k0), (s1, _, _) in zip(trace, trace[1:]):
        assert k0.shape == s1.shape == (len(LENS), W)
        assert (s1[:, :-1] >= s1[:, 1:]).all()
    for b in range(len(LENS)):
        paths = []
        for j in range(W):
            path = []
            for _, _, k in reversed(trace):
                path.append(int(k[b, j]) % V)
                j = int(k[b, j]) // V
            paths.append(path[::-1])
        assert toks[b].tolist() in paths
