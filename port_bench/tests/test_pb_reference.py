"""The plain reference against the program's plain path at a tiny size on
the CPU, in float32, for multi-query and multi-head attention: the logits,
the loss and every gradient.  (The tests may import the program; the
reference may not.)"""

import dataclasses

import pytest
import torch

from port_bench import program, weights
from port_bench.reference import gpt
from port_bench.tests.tiny import CONFIG, MHA
from port_bench.spec import shape_of


def port_model(cfg, w):
    from tpu_flash_torch.nn.transformer import DecoderLM

    shape = shape_of(cfg)
    dc = dataclasses.replace(program.decoder_config(shape, cfg),
                             dtype=torch.float32)
    model = DecoderLM(dc, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return model


@pytest.mark.parametrize("cfg", [CONFIG, MHA], ids=["mqa", "mha"])
def test_reference_matches_the_program_in_fp32(cfg):
    shape = shape_of(cfg)
    w = {n: t.float() for n, t in
         weights.make(shape, 11, "cpu").items()}
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, shape.vocab, (2, 48), generator=g)
    labels = torch.randint(0, shape.vocab, (2, 48), generator=g)
    model = port_model(cfg, w)
    logits = model(ids)
    ref = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref_logits = gpt.linear(gpt.hidden(ref, shape, ids), ref["lm_head.weight"],
                            ref["lm_head.bias"], None)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-5, atol=1e-5)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, shape.vocab), labels.reshape(-1))
    loss.backward()
    ref_loss = gpt.loss_sum(ref, shape, ids, labels, remat=True) / ids.numel()
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, ref[n].grad, rtol=1e-4, atol=1e-6,
                                   msg=n)


def test_fp8_control_rounds_every_product():
    a = torch.randn(8, 16, dtype=torch.float64)
    b = torch.randn(16, 4, dtype=torch.float64)
    exact = a @ b
    low = gpt.matmul(a, b, "fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        gpt.matmul(a, b, "int3")


def test_logits_at_is_the_full_forward():
    shape = shape_of(CONFIG)
    w = {n: t.float() for n, t in weights.make(shape, 5, "cpu").items()}
    tokens = list(range(30))
    full = gpt.linear(gpt.hidden(w, shape, torch.tensor([tokens])),
                      w["lm_head.weight"], w["lm_head.bias"], None)[0]
    torch.testing.assert_close(gpt.logits_at(w, shape, tokens, [3, 29]),
                               full[[3, 29]])
