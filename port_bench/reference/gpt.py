"""Plain PyTorch reference of a GPT-style decoder with learned positions,
pre-LN blocks, tanh-GELU and multi-query or multi-head attention (GPT-2,
gpt_bigcode): the forward pass, the mean next-token cross-entropy, its
gradients, and Adam.

It imports nothing but ``torch``: no kernel, cache or batching of the
program under test.  Everything is float32 with TF32 off (``exact_fp32``);
attention is causal, taken a block of queries at a time so that the scores
of one block are alive at once.  ``quant="fp8"`` is the control: every
matrix product's two operands, and in the backward the gradient that comes
into it, rounded to float8_e4m3fn with one scale a tensor (amax / 448),
the products accumulated in float32.

The weights are a dict ``name -> tensor`` keyed as ``port_bench.spec``
names the leaves; the caller makes them from the seed and hands the same
values to the program."""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

BLOCK = 1024          # query rows a block
FP8_MAX = 448.0       # largest normal of float8_e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn at one scale for the tensor, back in
    ``x``'s dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands in fp8, and in the backward the
    incoming gradient in fp8 too: each product of the forward and the
    backward takes fp8 operands and accumulates in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def matmul(a: torch.Tensor, b: torch.Tensor, quant: str | None
           ) -> torch.Tensor:
    if quant == "fp8":
        return _Fp8Matmul.apply(a, b)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return a @ b


def linear(x, w, b, quant):
    return matmul(x, w.t(), quant) + b


def layer_norm(x, gamma, beta, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3))))


def causal_attention(q, k, v, quant, block=BLOCK):
    """q [B, H, L, d], k and v [B, Hkv, L, d] -> [B, H, L, d]; query i
    sees keys 0..i.  The query heads of one KV head share it."""
    B, H, L, d = q.shape
    hkv = k.shape[1]
    q = q.reshape(B, hkv, H // hkv, L, d)
    k, v = k[:, :, None], v[:, :, None]
    outs = []
    for s in range(0, L, block):
        e = min(L, s + block)
        scores = matmul(q[:, :, :, s:e], k[:, :, :, :e].transpose(-1, -2),
                        quant) * (1.0 / math.sqrt(d))
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        outs.append(matmul(torch.softmax(scores, dim=-1), v[:, :, :, :e],
                           quant))
    return torch.cat(outs, dim=3).reshape(B, H, L, d)


def block(w, i, x, shape, quant):
    """One pre-LN layer: ``x + attn(ln_1(x))``, then ``+ ff(ln_2(.))``."""
    p = f"layers.{i}."
    B, L, _ = x.shape
    d = shape.head_dim
    h = layer_norm(x, w[p + "ln_1.gamma"], w[p + "ln_1.beta"], shape.ln_eps)

    def proj(name):
        y = linear(h, w[p + f"attention.{name}_projection.weight"],
                   w[p + f"attention.{name}_projection.bias"], quant)
        return y.reshape(B, L, -1, d).transpose(1, 2)

    a = causal_attention(proj("q"), proj("k"), proj("v"), quant)
    a = a.transpose(1, 2).reshape(B, L, shape.n_embd)
    x = x + linear(a, w[p + "attention.out_projection.weight"],
                   w[p + "attention.out_projection.bias"], quant)
    h = layer_norm(x, w[p + "ln_2.gamma"], w[p + "ln_2.beta"], shape.ln_eps)
    h = gelu_tanh(linear(h, w[p + "ff.linear_in.weight"],
                         w[p + "ff.linear_in.bias"], quant))
    return x + linear(h, w[p + "ff.linear_out.weight"],
                      w[p + "ff.linear_out.bias"], quant)


def hidden(w, shape, ids, quant=None, remat=False):
    """ids [B, L] -> the final LayerNorm's output [B, L, E].  ``remat``
    keeps only each layer's input for the backward."""
    L = ids.shape[1]
    x = (w["token_embeddings.weight"][ids]
         + w["position_embeddings.weight"][:L])
    for i in range(shape.n_layer):
        if remat:
            x = checkpoint(block, w, i, x, shape, quant, use_reentrant=False)
        else:
            x = block(w, i, x, shape, quant)
    return layer_norm(x, w["ln.gamma"], w["ln.beta"], shape.ln_eps)


def _ce_sum(h, labels, wt, bias, quant):
    logits = linear(h, wt, bias, quant)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss_sum(w, shape, ids, labels, quant=None, remat=False,
             rows_a_chunk=2048):
    """Summed next-token cross-entropy of ``ids`` [B, L] against
    ``labels`` [B, L], the logits formed ``rows_a_chunk`` tokens at a time
    (recomputed in the backward)."""
    h = hidden(w, shape, ids, quant, remat).reshape(-1, shape.n_embd)
    y = labels.reshape(-1)
    total = 0.0
    for s in range(0, h.shape[0], rows_a_chunk):
        args = (h[s:s + rows_a_chunk], y[s:s + rows_a_chunk],
                w["lm_head.weight"], w["lm_head.bias"], quant)
        total = total + (checkpoint(_ce_sum, *args, use_reentrant=False)
                         if remat else _ce_sum(*args))
    return total


def half_batch(ids, labels):
    """The first half of a batch's tokens: half its rows, or of a single
    row half its positions."""
    if ids.shape[0] > 1:
        return ids[:ids.shape[0] // 2], labels[:ids.shape[0] // 2]
    return ids[:, :ids.shape[1] // 2], labels[:, :ids.shape[1] // 2]


def adam_train(w0, shape, batches, *, lr, beta1, beta2, eps, quant=None,
               half=False, judge=None, capture=False):
    """Adam (Kingma and Ba, arXiv:1412.6980, Algorithm 1 with the step
    size folded: ``lr * sqrt(1 - b2^t) / (1 - b1^t)``, ``sqrt(v) + eps``)
    on the mean cross-entropy, one step a batch of ``batches`` ((ids,
    labels) pairs, [B, L] each), from the float32 weights ``w0``.

    ``half`` trains on the first half of each batch's tokens alone (a
    fault).  Each
    row's backward runs on its own and the gradients add, so one row's
    activations are alive at a time.  Returns the losses, each leaf's
    gradient norm at the first step, and each leaf's change after the
    last step; with ``judge`` (name -> another side's first gradient, on
    the host) each leaf's distance from it, and with ``capture`` the first
    gradients themselves, on the host."""
    params = {n: t.detach().float().clone().requires_grad_(True)
              for n, t in w0.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad_norms, dists, grads = [], {}, {}, {}
    for t, (ids, labels) in enumerate(batches, start=1):
        if half:
            ids, labels = half_batch(ids, labels)
        n_tok = ids.numel()
        total = 0.0
        for b in range(ids.shape[0]):
            part = loss_sum(params, shape, ids[b:b + 1], labels[b:b + 1],
                            quant, remat=True) / n_tok
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            step = lr * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if t == 1:
                    grad_norms[n] = float(torch.linalg.vector_norm(g))
                    if judge is not None:
                        dists[n] = float(torch.linalg.vector_norm(
                            g - judge[n].to(g.device, torch.float32)))
                    if capture:
                        grads[n] = g.to("cpu", copy=True)
                m[n].mul_(beta1).add_(g, alpha=1 - beta1)
                v[n].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                p.sub_(step * m[n] / (v[n].sqrt() + eps))
                p.grad = None
    change = {n: float(torch.linalg.vector_norm(p.detach() - w0[n].float()))
              for n, p in params.items()}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                grad_dists=dists, grads=grads)


@torch.no_grad()
def logits_at(w, shape, tokens, rows, quant=None):
    """The logits [len(rows), V] at positions ``rows`` of one sequence
    ``tokens`` (a list of ids)."""
    dev = w["lm_head.weight"].device
    ids = torch.tensor(tokens, dtype=torch.long, device=dev)[None]
    h = hidden(w, shape, ids, quant)[0]
    rows = torch.tensor(rows, dtype=torch.long, device=dev)
    return linear(h[rows], w["lm_head.weight"], w["lm_head.bias"], quant)
