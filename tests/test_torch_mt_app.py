"""The port's MT app pieces against the JAX package's: corpus BLEU against
``sacrebleu`` (within 1e-9), ``skip_nonfinite`` over Adam and
mixed-precision Adam (within 1e-6), checkpoints (a JAX-written one read by
the port, logits within 1e-5; the port's own round trip exact, async and
bf16 included), the metrics log, and the refusals of what is not ported
(each naming its ROADMAP.md item)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.utils import checkpoint as jckpt
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tapp
from tpu_flash_torch.nn import optim as topt
from tpu_flash_torch.utils import bleu as tbleu
from tpu_flash_torch.utils import checkpoint as tckpt
from tpu_flash_torch.utils.metrics import MetricsLogger, read_metrics

torch.set_num_threads(1)

BLEU_CASES = {
    "punctuation and digits": (
        ["The cat, 3.5 kg, sat on the mat.", "He said: \"no!\" (twice)",
         "In 1999-2000 we paid $4,000 & more."],
        ["The cat, 3.5 kg, sat on a mat.", "He said: \"No!\" (twice)",
         "In 1999-2000 we paid $4,000 and more."]),
    "empty hypothesis": (["", "a b c d e"], ["x y z", "a b c d e"]),
    "no n-gram match": (["p q r s"], ["a b c d"]),
    "hypothesis longer than its reference": (
        ["the cat sat on the mat today again and again"],
        ["the cat sat on the mat"]),
    "short, no 4-gram": (["a b c"], ["a b c"]),
    "html entities and newlines": (["a &amp; b &lt;c&gt;\nd-\ne"],
                                   ["a & b <c> de"]),
    "german": (["Ich habe es gesehen, oder?", "Die Kinder lesen."],
               ["Ich habe es gesehen , oder ?", "Die Kinder lesen ein Buch."]),
}


@pytest.mark.parametrize("case", list(BLEU_CASES))
def test_corpus_bleu_matches_sacrebleu(case):
    sacrebleu = pytest.importorskip("sacrebleu")
    hyps, refs = BLEU_CASES[case]
    want = sacrebleu.metrics.BLEU().corpus_score(hyps, [refs]).score
    got = tapp.evaluate_bleu([{"en": r} for r in refs], hyps, "en")["bleu"]
    assert abs(got - want) <= 1e-9, (got, want)
    assert tbleu.tokenize_13a(hyps[0]) == \
        sacrebleu.tokenizers.tokenizer_13a.Tokenizer13a()(hyps[0])


def test_corpus_bleu_two_reference_streams():
    sacrebleu = pytest.importorskip("sacrebleu")
    hyps = ["the cat is on the mat", "there is a dog here"]
    refs = [["the cat sat on the mat", "a dog is here"],
            ["there is a cat on the mat", "there is a dog here ."]]
    want = sacrebleu.metrics.BLEU().corpus_score(hyps, refs).score
    assert abs(tbleu.corpus_bleu(hyps, refs) - want) <= 1e-9


def _trees(rng, dtype=np.float32):
    shapes = {"a.weight": (5, 7), "a.bias": (7,), "b.gamma": (3,)}
    params = {n: rng.standard_normal(s).astype(dtype)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
              for n, s in shapes.items()} for i in range(4)]
    grads[2]["a.bias"][3] = np.nan          # one non-finite step
    grads[2]["b.gamma"][0] = np.inf
    return params, grads


@pytest.mark.parametrize("mixed", [False, True])
def test_skip_nonfinite_matches_jax(rng, mixed):
    params, grads = _trees(rng)
    jtx = jnn.optim.skip_nonfinite(
        jnn.mixed_precision(jnn.adam(lr=1e-2)) if mixed
        else jnn.adam(lr=1e-2))
    ttx = topt.skip_nonfinite(
        topt.mixed_precision(topt.adam(lr=1e-2)) if mixed
        else topt.adam(lr=1e-2))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    if mixed:
        jp = {n: v.astype(jnp.bfloat16) for n, v in jp.items()}
        tp = {n: v.to(torch.bfloat16) for n, v in tp.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i, g in enumerate(grads):
        before = {n: v.clone() for n, v in tp.items()}
        jp, js = jtx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        tp, ts = ttx.update({n: torch.from_numpy(v) for n, v in g.items()},
                            ts, tp)
        if i == 2:                          # the skipped step: bit-equal
            for n in tp:
                assert torch.equal(tp[n], before[n])
    adam_t = ts.inner.inner if mixed else ts.inner
    adam_j = js.inner.inner if mixed else js.inner
    assert torch.is_tensor(ts.skipped) and ts.skipped.dtype == torch.int32
    assert int(ts.skipped) == int(js.skipped) == 1
    assert torch.is_tensor(adam_t.step) and adam_t.step.dim() == 0
    assert adam_t.step.dtype == torch.int32
    assert int(adam_t.step) == int(adam_j.step) == 3
    for n in params:
        np.testing.assert_allclose(tp[n].float().numpy(),
                                   np.asarray(jp[n], np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        for mt, mj in ((adam_t.exp_avg, adam_j.exp_avg),
                       (adam_t.exp_avg_sq, adam_j.exp_avg_sq)):
            np.testing.assert_allclose(mt[n].numpy(), np.asarray(mj[n]),
                                       rtol=1e-6, atol=1e-6, err_msg=n)
        if mixed:
            np.testing.assert_allclose(ts.inner.master[n].numpy(),
                                       np.asarray(js.inner.master[n]),
                                       rtol=1e-6, atol=1e-6, err_msg=n)


def test_cosine_schedule_takes_a_step_tensor():
    lr = topt.cosine_schedule(1e-2, 2, 6)
    jlr = jnn.optim.cosine_schedule(1e-2, 2, 6)
    for step in range(8):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert torch.is_tensor(got) and got.dim() == 0
        want = float(jlr(jnp.int32(step)))
        assert abs(float(got) - want) <= 1e-9, step


CFG = dict(n_vocab=64, n_embd=32, n_head=2, n_positions=16, n_layer=2,
           ff_middle_dim=64, p_dropout=0.0, attention_kind="naive")


def test_restore_reads_a_jax_checkpoint(tmp_path):
    """JAX's ``save_checkpoint`` of fp32 params (and an Adam state), read
    by the port's ``restore_checkpoint``: ``load_jax_params`` of its params
    gives the JAX model's logits within 1e-5."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(0))
    opt = jnn.adam()
    jckpt.save_checkpoint(str(tmp_path), 7,
                          {"params": params, "opt_state": opt.init(params)},
                          metadata={"lr": 0.02})
    tree, step, meta = tckpt.restore_checkpoint(str(tmp_path))
    assert step == 7 and meta == {"lr": 0.02}
    assert tree["opt_state"].step.dim() == 0
    assert tree["opt_state"]._fields == ("step", "exp_avg", "exp_avg_sq")
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, tree["params"])
    ids = np.random.default_rng(0).integers(0, CFG["n_vocab"], (2, 16))
    want = np.asarray(jax.jit(lambda p, x: jm(p, x))(params,
                                                     jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip(tmp_path, dtype):
    """The port's own state, saved synchronously and asynchronously, comes
    back bit for bit in its structure; JAX's restore reads the fp32 one;
    the newest three steps are kept."""
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, dtype=dtype), device="cpu")
    params = {n: p.detach() for n, p in tm.named_parameters()}
    opt = topt.skip_nonfinite(topt.mixed_precision(topt.adam()))
    state = opt.init(params)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    params, state = opt.update(grads, state, params)
    tree = {"params": params, "opt_state": state, "cursor": [3, None]}
    tckpt.save_checkpoint(str(tmp_path), 0, tree)
    with tckpt.AsyncCheckpointer() as ck:
        for step in (1, 2, 3):
            ck.save(str(tmp_path), step, tree, metadata={"step": step})
        assert ck.wait().endswith("step_3")
    assert tckpt.list_checkpoints(str(tmp_path)) == [1, 2, 3]
    got, step, meta = tckpt.restore_checkpoint(str(tmp_path))
    assert (step, meta) == (3, {"step": 3})
    assert got["cursor"][1] is None and int(got["cursor"][0]) == 3
    like = tckpt.restore_like(state, got["opt_state"])
    assert type(like) is type(state)
    want = dict(tckpt._flatten_with_paths((params, state)))
    have = dict(tckpt._flatten_with_paths((got["params"], like)))
    assert want.keys() == have.keys()
    for k, a in want.items():
        assert a.dtype == have[k].dtype and torch.equal(a, have[k]), k
    if dtype == torch.float32:
        jtree, jstep, _ = jckpt.restore_checkpoint(str(tmp_path))
        assert jstep == 3
        for n, p in params.items():
            np.testing.assert_array_equal(np.asarray(jtree["params"][n]),
                                          p.numpy())


def test_async_checkpointer_reraises_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = tckpt.AsyncCheckpointer()
    ck.save(str(blocker), 0, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.close()


def test_metrics_logger_writes_strict_json(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    with MetricsLogger(path, run={"cfg": {"lr": 0.5}}) as m:
        m.log(step=0, loss=torch.tensor(1.5), nan=float("nan"),
              inf=np.float32("inf"), n=np.int64(3))
        m.log(event="bleu", bleu=12.5)
    recs = read_metrics(path)
    assert recs[0] == {"event": "run_start", "cfg": {"lr": 0.5}}
    assert recs[1]["loss"] == 1.5 and recs[1]["nan"] is None
    assert recs[1]["inf"] is None and recs[1]["n"] == 3
    assert recs[2]["step"] == 1 and recs[2]["bleu"] == 12.5
    for line in path.read_text().splitlines():
        json.loads(line, parse_constant=lambda c: pytest.fail(c))
    assert math.isfinite(recs[2]["wall"])


def test_main_needs_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(["--workdir", str(tmp_path)])
