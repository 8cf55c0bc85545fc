"""The port's speculative decoding and shared-prefix caching against the JAX
package's: ``speculative_generate`` and the engine's ``run_speculative``
(with a draft model unlike the target, with the target as its own draft,
near the cache's end, after chunked prefill) and ``set_prefix`` give the
JAX greedy tokens on the same JAX-initialized parameters and prompts from a
numpy seed; the stochastic path samples the target's distribution.

Before any comparison, the fixtures check that every greedy decision of
the reference has a top-2 logit gap above 1e-4: the two frameworks' logits
agree to 1e-5 in fp32, so no near-tie can flip a token."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import SamplingConfig as JaxSampling
from tpu_flash.inference import speculative_generate as jax_speculative
from tpu_flash.inference.engine import DecodeEngine as JaxEngine
from tpu_flash.inference.engine import Request as JaxRequest
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import (DecodeEngine, Request, SamplingConfig,
                                       generate, speculative_generate)

torch.set_num_threads(1)

CFG = dict(n_vocab=64, n_embd=32, n_head=4, n_positions=64, n_layer=2,
           ff_middle_dim=64, p_dropout=0.0, attention_kind="naive")
DRAFT = dict(CFG, n_embd=16, n_head=2, n_layer=1)
LENS = [3, 9, 5, 12]
N_NEW, MAX_LEN = 12, 40
WIDTH = 32            # the gap check's padded width: one compile


def pair(cfg, seed):
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg))
    params = jax.jit(jm.init)(jax.random.key(seed))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**cfg), device="cpu")
    tnn.load_jax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def ref():
    """Target and draft (JAX and port), prompts, the JAX greedy tokens, and
    a check of any prompt's greedy continuation for near ties."""
    jm, params, tm = pair(CFG, 0)
    jd, dparams, td = pair(DRAFT, 5)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG["n_vocab"], n).tolist() for n in LENS]
    ids = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    # JAX's speculative decode; the check below proves its tokens greedy
    run = jax.jit(lambda p, dp, i, n: jax_speculative(
        jm, p, jd, dp, i, n, JaxSampling(max_new_tokens=N_NEW),
        max_len=MAX_LEN, n_draft=4))
    tokens, n_gen = (np.asarray(x) for x in run(
        params, dparams, jnp.asarray(ids), jnp.asarray(LENS)))
    forward = jax.jit(lambda p, x: jm(p, x))

    def assert_far_from_ties(prompt, toks):
        x = np.zeros((1, WIDTH), np.int32)
        x[0, :len(prompt) + len(toks)] = list(prompt) + list(toks)
        logits = np.asarray(forward(params, jnp.asarray(x)))[0]
        rows = logits[len(prompt) - 1:len(prompt) - 1 + len(toks)]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
        assert (rows.argmax(-1) == np.asarray(toks)).all()

    for p, t in zip(prompts, tokens):
        assert_far_from_ties(p, t)
    return dict(jm=jm, params=params, model=tm, jd=jd, dparams=dparams,
                draft=td, prompts=prompts, ids=ids, tokens=tokens,
                n_gen=n_gen, check=assert_far_from_ties)


def engine(ref, draft="draft", **kw):
    kw = {"n_slots": 2, "max_len": MAX_LEN,
          "sampling": SamplingConfig(max_new_tokens=N_NEW), **kw}
    if draft is not None:
        kw["draft_model"] = ref[draft]
    eng = DecodeEngine(ref["model"], device="cpu", **kw)
    for uid, p in enumerate(ref["prompts"]):
        eng.submit(Request(uid, p))
    return eng


def completions(done):
    return {c.uid: (c.tokens, c.finished_reason) for c in done}


@pytest.mark.parametrize("n_draft,draft_quant", [(1, "none"), (2, "none"),
                                                 (4, "none"), (3, "int8")])
def test_speculative_generate_matches_jax_and_generate(ref, n_draft,
                                                       draft_quant):
    """Equal to JAX's ``speculative_generate`` (n_draft 4, this draft) and
    to the port's ``generate``."""
    sampling = SamplingConfig(max_new_tokens=N_NEW)
    toks, n = speculative_generate(
        ref["model"], ref["draft"], ref["ids"], LENS, sampling,
        max_len=MAX_LEN, n_draft=n_draft, draft_kv_quant=draft_quant,
        device="cpu")
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])
    want, want_n = generate(ref["model"], ref["ids"], LENS, sampling,
                            max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want.numpy())
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    np.testing.assert_array_equal(n.numpy(), ref["n_gen"])


def test_speculative_self_draft_accepts_every_draft(ref):
    """The target as its own draft: every draft accepted, in the fewest
    rounds (the prefill's token, then n_draft a round); a corrupted draft
    cache would show here, not in the tokens."""
    n_draft = 4
    toks, _, stats = speculative_generate(
        ref["model"], ref["model"], ref["ids"], LENS,
        SamplingConfig(max_new_tokens=N_NEW), max_len=MAX_LEN,
        n_draft=n_draft, return_stats=True, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])
    assert torch.equal(stats["accepted"], stats["drafted"])
    assert stats["rounds"] == math.ceil((N_NEW - 1) / n_draft)


def test_speculative_eos_stops(ref):
    """eos as the fifth greedy token of prompt 0: speculative decoding stops
    where greedy decoding does, later emissions of the round dropped."""
    eos = int(ref["tokens"][0, 4])
    sampling = SamplingConfig(max_new_tokens=N_NEW, eos_id=eos)
    want, want_n = generate(ref["model"], ref["ids"], LENS, sampling,
                            max_len=MAX_LEN, device="cpu")
    toks, n = speculative_generate(ref["model"], ref["draft"], ref["ids"],
                                   LENS, sampling, max_len=MAX_LEN,
                                   n_draft=3, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want.numpy())
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    assert int(n[0]) <= 5


def tiny_pair(V, seed):
    torch.manual_seed(seed)
    cfg = dict(CFG, n_vocab=V, n_embd=16, n_head=2, n_layer=1,
               n_positions=32)
    gen = torch.Generator().manual_seed(seed)
    models = []
    for s in (0, 1):
        m = tnn.DecoderLM(tnn.DecoderConfig(**cfg), device="cpu")
        tnn.init_params(m, gen.manual_seed(seed + s))
        models.append(m)
    return models


def test_stochastic_matches_target_distribution():
    """Rejection sampling makes each token distributed as the target's own
    sampling whatever the draft: the empirical joint of the first two
    tokens against the exact target joint (a vocabulary of 8, so the joint
    has 64 cells; sampling noise at 4096 draws gives TV ~0.06)."""
    V, temp = 8, 0.8
    model, draft = tiny_pair(V, 11)
    prompt = [3, 1, 5, 2]
    with torch.no_grad():
        def next_dist(ids):
            return torch.softmax(model(torch.tensor([ids]))[0, -1].double()
                                 / temp, -1)

        p1 = next_dist(prompt)
        p2 = torch.stack([next_dist(prompt + [v]) for v in range(V)])
    joint = (p1[:, None] * p2).numpy()
    B = 2048
    sampling = SamplingConfig(max_new_tokens=2, temperature=temp)
    gen = torch.Generator().manual_seed(42)
    emp = np.zeros((V, V))
    for _ in range(2):
        toks, _ = speculative_generate(
            model, draft, np.tile(prompt, (B, 1)), [len(prompt)] * B,
            sampling, max_len=16, n_draft=3, generator=gen, device="cpu")
        np.add.at(emp, (toks[:, 0].numpy(), toks[:, 1].numpy()), 1.0)
    emp /= emp.sum()
    tv = 0.5 * np.abs(emp - joint).sum()
    assert tv < 0.13, f"TV distance {tv:.3f}"


def test_stochastic_topk_topp_smoke():
    V = 32
    model, draft = tiny_pair(V, 3)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, V, (3, 9))
    sampling = SamplingConfig(max_new_tokens=8, temperature=0.9, top_k=4,
                              top_p=0.95)
    toks, n = speculative_generate(
        model, draft, ids, [9, 4, 6], sampling, max_len=32, n_draft=3,
        generator=torch.Generator().manual_seed(1), device="cpu")
    assert toks.shape == (3, 8)
    assert ((toks >= 0) & (toks < V)).all() and (n >= 1).all()


def test_engine_speculative_matches_jax_engine(ref):
    """2 slots for 4 requests under the guard's probation (speculative
    rounds and plain steps alternate, so the draft's caches fall behind
    the target's, as in JAX): JAX's speculative engine's completions."""
    jeng = JaxEngine(ref["jm"], ref["params"], n_slots=2, max_len=MAX_LEN,
                     sampling=JaxSampling(max_new_tokens=N_NEW),
                     draft_model=ref["jd"], draft_params=ref["dparams"],
                     n_draft=3)
    for uid, p in enumerate(ref["prompts"]):
        jeng.submit(JaxRequest(uid, p))
    want = completions(jeng.run_speculative())
    assert {u: t for u, (t, _) in want.items()} == {
        u: ref["tokens"][u].tolist() for u in range(len(LENS))}
    got = completions(engine(ref, n_draft=3).run_speculative())
    assert got == want


def test_engine_speculative_near_capacity(ref):
    """A 16-row cache and n_draft 6 with the target as its own draft: the
    rounds shrink near the end instead of retiring early, so the
    completions (tokens and reason) are the plain engine's and the JAX
    greedy tokens' prefixes."""
    def run(**kw):
        eng = DecodeEngine(ref["model"], n_slots=2, max_len=16,
                           sampling=SamplingConfig(max_new_tokens=30),
                           device="cpu", **kw)
        for uid in (0, 1):
            eng.submit(Request(uid, ref["prompts"][uid]))
        return eng

    want = completions(run().run_many(4))
    spec = run(draft_model=ref["model"], n_draft=6)
    got = completions(spec.run_speculative())
    assert got == want
    for uid, (toks, reason) in got.items():
        assert reason == "length"
        assert toks == ref["tokens"][uid][:len(toks)].tolist()
    assert spec._spec_stats["accepted"] > 0


@pytest.mark.parametrize("draft", ["draft", "model"])
def test_engine_speculative_after_chunked_prefill(ref, draft):
    """Chunked prefill fills the target's and the draft's caches (with no
    decode step between chunks); the rounds then give the greedy tokens."""
    got = completions(engine(ref, draft, prefill_chunk=4,
                             n_draft=3).run_speculative(None))
    assert got == {u: (ref["tokens"][u].tolist(), "length")
                   for u in range(len(LENS))}


def test_engine_speculative_guard(ref):
    """probe_rounds=2: both modes timed at least twice, a decision with
    both rates and the acceptance fraction, and the completions of the
    plain engine whichever mode wins; the self-draft's acceptance (every
    draft but where a slot retires) is above the random draft's;
    ``accepted`` counts emitted tokens less one a slot a round."""
    want = completions(engine(ref, None).run())
    spec = engine(ref, n_draft=3)
    assert completions(spec.run_speculative(probe_rounds=2)) == want
    d, st = spec.spec_decision, spec._spec_stats
    assert d is not None and d["mode"] in ("speculative", "plain")
    assert d["spec_tps"] > 0 and d["plain_tps"] > 0
    assert 0.0 <= d["acceptance"] <= 1.0
    assert st["spec_timed"] >= 2 and st["plain_timed"] >= 2
    assert 0 <= st["accepted"] <= st["proposed"]

    selfd = engine(ref, "model", n_draft=3)
    assert completions(selfd.run_speculative(probe_rounds=None)) == want
    s3 = selfd._spec_stats
    assert selfd.spec_decision is None and s3["plain_timed"] == 0
    self_acc = s3["accepted"] / s3["proposed"]
    assert self_acc >= 0.6
    assert self_acc > st["accepted"] / max(st["proposed"], 1)
    # emitted less accepted is the active slots summed over the rounds
    # (1 or 2 of the 2 slots)
    assert s3["rounds"] <= s3["emitted"] - s3["accepted"] <= 2 * s3["rounds"]

    one = DecodeEngine(ref["model"], n_slots=2, max_len=MAX_LEN,
                       sampling=SamplingConfig(max_new_tokens=9),
                       draft_model=ref["model"], n_draft=4, device="cpu")
    one.submit(Request(0, ref["prompts"][0]))
    one.admit()
    steps = 0
    while one.has_work():
        one.step_speculative()
        steps += 1
    # the prefill's token, then two rounds of 4
    assert steps == 2 and one.completions[0].tokens == (
        ref["tokens"][0][:9].tolist())


def test_engine_self_draft_under_probation_matches_jax(ref):
    """The target as its own draft under a probation that outlasts the
    drain (probe_rounds=50, so no decision): JAX's completions.  A plain
    step of the probation feeds the draft too (a stated deviation: JAX's
    feeds the target only, so after one its draft proposes from a context
    a token short), so the port's probation accepts as large a share of
    its proposals as the same engine without the guard, where JAX's
    accepts a smaller one, and it needs fewer rounds than JAX's."""
    keys = ("rounds", "proposed", "emitted", "accepted", "spec_timed",
            "plain_timed")
    jeng = JaxEngine(ref["jm"], ref["params"], n_slots=2, max_len=MAX_LEN,
                     sampling=JaxSampling(max_new_tokens=N_NEW),
                     draft_model=ref["jm"], draft_params=ref["params"],
                     n_draft=3)
    for uid, p in enumerate(ref["prompts"]):
        jeng.submit(JaxRequest(uid, p))
    want = completions(jeng.run_speculative(probe_rounds=50))
    spec = engine(ref, "model", n_draft=3)
    assert completions(spec.run_speculative(probe_rounds=50)) == want
    st = spec._spec_stats
    assert spec.spec_decision is None and jeng.spec_decision is None
    jst = {k: int(jeng._spec_stats[k]) for k in keys}
    assert st["plain_timed"] > 0 and jst["plain_timed"] > 0
    assert st["draft_fed"] == spec.stats["decode_steps"]
    assert torch.equal(spec.draft_caches[0].lengths, spec.caches[0].lengths)
    assert st["rounds"] < jst["rounds"]
    unguarded = engine(ref, "model", n_draft=3)
    unguarded.run_speculative(probe_rounds=None)
    u = unguarded._spec_stats
    acceptance = st["accepted"] / st["proposed"]
    assert acceptance >= u["accepted"] / u["proposed"]
    assert jst["accepted"] / jst["proposed"] < acceptance


@pytest.fixture(scope="module")
def prefixed(ref):
    """A 7-token system prompt, three prompts that start with it (one is
    the bare prefix) and one that does not, and JAX's prefix-cached
    engine's completions."""
    rng = np.random.default_rng(8)
    prefix = rng.integers(1, CFG["n_vocab"], 7).tolist()
    prompts = [prefix + rng.integers(1, CFG["n_vocab"], 3).tolist(),
               prefix + rng.integers(1, CFG["n_vocab"], 1).tolist(),
               prefix, rng.integers(1, CFG["n_vocab"], 3).tolist()]
    jeng = JaxEngine(ref["jm"], ref["params"], n_slots=2, max_len=MAX_LEN,
                     sampling=JaxSampling(max_new_tokens=N_NEW),
                     prefill_chunk=4)
    jeng.set_prefix(prefix)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid, p))
    want = completions(jeng.run())
    for uid, p in enumerate(prompts):
        ref["check"](p, want[uid][0])
    return prefix, prompts, want


@pytest.mark.parametrize("n_slots,draft", [(2, None), (1, None),
                                           (2, "draft")])
def test_set_prefix_matches_jax_and_uncached(ref, prefixed, n_slots, draft):
    """With one slot, the prompts that share the prefix are admitted one
    after the other into it: each must start from the stored prefix caches,
    not from what the admission before it wrote there."""
    prefix, prompts, want = prefixed

    def run(with_prefix):
        eng = DecodeEngine(ref["model"], n_slots=n_slots, max_len=MAX_LEN,
                           sampling=SamplingConfig(max_new_tokens=N_NEW),
                           prefill_chunk=4, device="cpu",
                           draft_model=draft and ref[draft], n_draft=3)
        if with_prefix:
            eng.set_prefix(prefix)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p))
        return completions(eng.run() if draft is None
                           else eng.run_speculative(None))

    cached = run(True)
    assert cached == want
    assert cached == run(False)


def test_set_prefix_admissions_leave_the_stored_caches(ref, prefixed):
    """Two prompts with the prefix admitted one after the other into one
    slot: the stored prefix caches stay as ``set_prefix`` left them, and
    each admission's rows and first token equal the uncached engine's."""
    prefix, prompts, want = prefixed

    def one_slot(with_prefix):
        eng = DecodeEngine(ref["model"], n_slots=1, max_len=MAX_LEN,
                           sampling=SamplingConfig(max_new_tokens=N_NEW),
                           prefill_chunk=4, device="cpu")
        if with_prefix:
            eng.set_prefix(prefix)
        return eng

    cached, uncached = one_slot(True), one_slot(False)
    stored = [(c.k.clone(), c.v.clone(), c.lengths.clone())
              for c in cached._prefix_caches[False]]
    for uid in (0, 1):
        n = len(prompts[uid])
        for eng in (cached, uncached):
            eng.submit(Request(uid, prompts[uid]))
            eng.admit()
        assert cached.slot_tokens[0] == uncached.slot_tokens[0] == (
            want[uid][0][:1])
        for a, b in zip(cached.caches, uncached.caches):
            torch.testing.assert_close(a.k[0, :n], b.k[0, :n])
            torch.testing.assert_close(a.v[0, :n], b.v[0, :n])
            assert int(a.lengths[0]) == int(b.lengths[0]) == n
        for c, (k, v, lengths) in zip(cached._prefix_caches[False], stored):
            assert torch.equal(c.k, k) and torch.equal(c.v, v)
            assert torch.equal(c.lengths, lengths)
        for eng in (cached, uncached):
            assert completions(eng.run())[uid] == want[uid]


def test_bad_arguments_raise(ref):
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(ref["model"], n_slots=1, max_len=16,
                     sampling=SamplingConfig(),
                     device="cpu").set_prefix([1, 2])
    with pytest.raises(ValueError, match="n_draft"):
        DecodeEngine(ref["model"], n_slots=1, max_len=16,
                     sampling=SamplingConfig(), draft_model=ref["draft"],
                     n_draft=0, device="cpu")
    with pytest.raises(ValueError, match="draft_model"):
        DecodeEngine(ref["model"], n_slots=1, max_len=16,
                     sampling=SamplingConfig(),
                     device="cpu").step_speculative()
