"""The system under test, as the benchmark builds it: a ``DecoderLM`` of
``tpu_flash_torch`` with a configuration's shapes and the seed's weights.
The drivers take the model, the training step and the engine from here and
from the program's own entry points; nothing else of the program is used."""

from __future__ import annotations

import torch

from port_bench.spec import Shape

GELU_TANH = ("gelu_new", "gelu_pytorch_tanh")


def decoder_config(shape: Shape, cfg: dict):
    from tpu_flash_torch.nn.transformer import DecoderConfig

    if cfg["activation_function"] not in GELU_TANH:
        raise ValueError(f"the port's feed-forward is tanh-GELU, not "
                         f"{cfg['activation_function']!r}")
    return DecoderConfig(
        n_vocab=shape.vocab, n_embd=shape.n_embd, n_head=shape.n_head,
        n_kv_head=shape.n_kv_head if shape.n_kv_head != shape.n_head else None,
        positional="learned", n_positions=shape.n_positions,
        n_layer=shape.n_layer, ff_middle_dim=shape.n_inner, p_dropout=0.0,
        ln_eps=shape.ln_eps, bias=True, causal=True, attention_kind="flash",
        use_fused_kernel=False, dtype=torch.bfloat16, remat=False)


def build_model(shape: Shape, cfg: dict, weights: dict, device):
    """A ``DecoderLM`` on ``device`` holding ``weights`` (name -> tensor,
    the names of ``Shape.leaves``, which are the model's own)."""
    from tpu_flash_torch.nn.transformer import DecoderLM

    model = DecoderLM(decoder_config(shape, cfg), device=device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        odd = sorted(set(params) ^ set(weights))
        raise ValueError(f"the model's leaves and the weights differ: {odd}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model
