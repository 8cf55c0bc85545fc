"""The port's MT app end to end on the CPU: ``generate_translations`` gives
the JAX app's hypotheses (exactly) on JAX's parameters carried across, over
fp32 and int8 caches; ``main()`` at tiny widths writes its tokenizer,
checkpoints and ``metrics.jsonl``, and ``--resume`` picks up from the last
epoch, as ``tests/test_data_mt.py`` checks of the JAX CLI."""

import json

import jax
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.apps import machine_translation as japp
from tpu_flash.data import mt as jmt
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tapp
from tpu_flash_torch.data import mt as tmt
from tpu_flash_torch.utils.checkpoint import list_checkpoints
from tpu_flash_torch.utils.metrics import read_metrics

torch.set_num_threads(1)

L = 40
CFG = dict(n_vocab=512, n_embd=32, n_head=2, n_positions=L, n_layer=1,
           ff_middle_dim=64, p_dropout=0.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The synthetic corpus (8 test examples), both tokenizers, the JAX
    model's params and the port's model holding them."""
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    ds = tmt.get_dataset("synthetic", L, synthetic=True, n_train=300,
                         n_validation=8, n_test=8)[0]
    jtok = jmt.get_tokenizer(ds["train"], 500, "de", "en",
                             str(tmp_path_factory.mktemp("jax")))
    ttok = tmt.get_tokenizer(ds["train"], 500, "de", "en",
                             str(tmp_path_factory.mktemp("port")))
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(3))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    return ds, jtok, ttok, jm, params, tm


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_generate_translations_matches_jax(pair, kv_quant, beam_size):
    """The model's vocabulary (512) is larger than the tokenizer's (500),
    as the app's is: ids without a token are left out by both.  Greedy and
    beam decoding run past the position table (prompt + 40 new tokens at
    L40), where both packages embed NaN."""
    ds, jtok, ttok, jm, params, tm = pair
    want = japp.generate_translations(jm, params, ds["test"], "de", "en",
                                      jtok, L, kv_quant=kv_quant,
                                      beam_size=beam_size)
    got = tapp.generate_translations(tm, ds["test"], "de", "en", ttok, L,
                                     kv_quant=kv_quant, beam_size=beam_size)
    assert got == want
    assert len(got) == 8 and any(h for h in got)


def test_nan_past_table_only_where_asked():
    """A position past the table embeds as NaN (JAX's fill) only under
    ``nan_past_table``, which ``generate`` sets only where its ``max_len``
    passes the table; elsewhere it is an index error, as before."""
    torch.manual_seed(0)
    m = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    idx, pos = torch.tensor([[5], [6]]), torch.tensor([[L - 1], [L]])
    logits = m(idx, positions=pos, nan_past_table=True)
    assert torch.isfinite(logits[0]).all() and torch.isnan(logits[1]).all()
    with pytest.raises(IndexError):
        m(idx, positions=pos)


def test_main_trains_checkpoints_logs_and_resumes(tmp_path):
    args = ["--dataset", "local", "--max-iters-per-epoch", "3",
            "--samples-per-epoch", "64", "--batch-size", "8",
            "--model-max-length", "24", "--n-vocab", "300",
            "--n-embd", "32", "--n-head", "2", "--n-layer", "1",
            "--checkpoint-every", "1", "--kv-quant", "int8",
            "--workdir", str(tmp_path)]
    first = tapp.main(args + ["--n-epochs", "2"], device="cpu")
    assert [r["epoch"] for r in first["epochs"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in first["epochs"])
    assert [b["epoch"] for b in first["bleu"]] == [0, 1]
    assert 0.0 <= first["bleu"][0]["bleu"] <= 100.0
    assert first["tokenizer_vocab"] == 300 and len(first["samples"]) == 3
    assert isinstance(first["model"], tnn.DecoderLM)
    assert list_checkpoints(str(tmp_path / "checkpoints")) == [0, 1]
    tok = json.loads((tmp_path / "tokenizer.json").read_text())
    assert len(tok["model"]["vocab"]) == 300
    # the resumed run: packed rows from the C++ ring, mixed precision off
    second = tapp.main(args + ["--n-epochs", "3", "--resume", "--pack",
                               "--native-loader", "--skip-bleu"],
                       device="cpu")
    assert [r["epoch"] for r in second["epochs"]] == [2]
    assert second["epochs"][0]["packed_dropped_examples"] >= 0
    assert list_checkpoints(str(tmp_path / "checkpoints")) == [0, 1, 2]
    recs = read_metrics(tmp_path / "metrics.jsonl")
    events = [r.get("event") for r in recs]
    assert events.count("run_start") == 2 and events.count("bleu") == 2
    assert [r["step"] for r in recs if r.get("event") == "epoch"] == [0, 1, 2]
    steps = [r for r in recs if "loss" in r and r.get("event") is None]
    assert steps and all(r["tokens_per_sec"] > 0 for r in steps)
    # nothing to resume from: a cold start
    cold = tapp.main(args + ["--n-epochs", "1", "--resume", "--skip-bleu",
                             "--workdir", str(tmp_path / "empty")],
                     device="cpu")
    assert [r["epoch"] for r in cold["epochs"]] == [0]


def test_main_bleu_by_beam_search(tmp_path):
    """``--beam-size 2``: the BLEU pass decodes by beam search."""
    args = ["--dataset", "local", "--max-iters-per-epoch", "2",
            "--samples-per-epoch", "32", "--batch-size", "8",
            "--model-max-length", "24", "--n-vocab", "300",
            "--n-embd", "32", "--n-head", "2", "--n-layer", "1",
            "--checkpoint-every", "0", "--beam-size", "2",
            "--workdir", str(tmp_path)]
    out = tapp.main(args, device="cpu")
    assert [b["epoch"] for b in out["bleu"]] == [0]
    assert 0.0 <= out["bleu"][0]["bleu"] <= 100.0
    assert len(out["samples"]) == 3


def test_main_refuses_a_vocab_below_the_tokenizer(tmp_path):
    with pytest.raises(SystemExit, match="byte-level BPE needs"):
        tapp.main(["--dataset", "local", "--n-vocab", "100", "--workdir",
                   str(tmp_path)], device="cpu")
