"""The port's fused path against the JAX package's, on the CPU: the fused
LayerNorm and masked attention-softmax kernels' plain versions against the
JAX Pallas kernels (run in interpret mode, ``impl="pallas"``), the
differentiable ops against ``jax.grad``, both size routes of the ops with
their output dtypes, and the tiny decoder (2 layers, E=64, 4 heads, L=64,
vocab 128) with ``attention_kind="fused"`` or ``"flash"`` and
``use_fused_kernel=True`` from the same JAX-initialized parameters.

Tolerances: 1e-5 absolute plus relative in fp32 for kernels, ops and the
model (both sides run the same fp32 arithmetic on the CPU, in another
summation order; the model's is the reference's module tolerance); 1e-6 for
the parameters after one SGD step (as ``tests/test_torch_training.py``);
bf16 outputs within one bf16 ulp (rtol 1e-2, the ulp being 2^-8 of |x| at
most, plus a 1e-5 floor for values near 0).  Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.apps import machine_translation as jmt
from tpu_flash.kernels.layernorm import (
    layernorm_backward as jax_ln_bwd,
    layernorm_forward as jax_ln_fwd,
)
from tpu_flash.kernels.softmax import (
    attn_softmax_backward as jax_sm_bwd,
    attn_softmax_forward as jax_sm_fwd,
)
from tpu_flash.ops import attn_softmax as jax_attn_softmax
from tpu_flash.ops import layer_norm as jax_layer_norm
from tpu_flash.ops import reference as jax_ref
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.apps import machine_translation as tmt
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.layernorm import (
    layernorm_backward,
    layernorm_forward,
)
from tpu_flash_torch.kernels.softmax import (
    attn_softmax_backward,
    attn_softmax_forward,
)
from tpu_flash_torch.ops import fused
from tpu_flash_torch.ops import reference as torch_ref

torch.set_num_threads(1)

TIGHT = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=1e-6, rtol=1e-6)
BF16 = dict(atol=1e-5, rtol=1e-2)
CFG = dict(n_vocab=128, n_embd=64, n_head=4, n_positions=64, n_layer=2,
           ff_middle_dim=128, p_dropout=0.0)
B, L = 2, 64


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# --- the kernels' plain versions against the Pallas kernels ----------------

@pytest.mark.parametrize("lead", [(37,), (4, 16)])
@pytest.mark.parametrize("H,dtype", [(64, "float32"), (200, "float32"),
                                     (512, "float32"), (512, "bfloat16")],
                         ids=["64", "200", "512", "512-bf16"])
def test_layernorm_kernels_match_jax(lead, H, dtype):
    """R = 37 or 64 rows (64 as [4, 16, H]), H = 64, 200 or 512 (the
    production width, training mode (e)), fp32 and at 512 bf16: y, mean,
    var, dx, dgamma and dbeta at 1e-5, the bf16 outputs within an ulp
    (mean and var stay fp32: 1e-5)."""
    x, g, b, dy = (np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
                   for a in arrays(1, (*lead, H), (H,), (H,), (*lead, H)))
    y, mean, var = jax_ln_fwd(*(jnp.asarray(a, dtype) for a in (x, g, b)),
                              interpret=True)
    dx, dg, db = jax_ln_bwd(*(jnp.asarray(a, dtype) for a in (dy, x, g)),
                            mean, var, interpret=True)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g, b, dy)]
    ty, tmean, tvar = layernorm_forward(t[0], t[1], t[2])
    got = layernorm_backward(t[3], t[0], t[1], torch.from_numpy(
        np.array(mean)), torch.from_numpy(np.array(var)))
    tol = TIGHT if dtype == "float32" else BF16
    for a, w, t_ in zip((ty, tmean, tvar, *got), (y, mean, var, dx, dg, db),
                        (tol, TIGHT, TIGHT, tol, tol, tol)):
        assert tuple(a.shape) == w.shape
        assert a.dtype == (getattr(torch, dtype) if t_ is tol
                           else torch.float32)
        close(a, np.asarray(jnp.asarray(w, jnp.float32)), **t_)


SOFTMAX_CASES = [
    # name, shape, mask_future, pad rows: None or the keys each batch keeps
    ("70x70", (2, 3, 70, 70), False, None),
    ("70x70-causal", (2, 3, 70, 70), True, None),
    ("130x70-causal-no-key-rows", (2, 3, 130, 70), True, None),
    ("70x200-pad-all-masked-row", (2, 3, 70, 200), False, (150, 0)),
    ("70x200-pad-causal", (2, 3, 70, 200), True, (150, 0)),
    ("64x256-pad-all-masked-row", (2, 3, 64, 256), False, (200, 0)),
]


def pad_mask(shape, keep):
    if keep is None:
        return None
    cols = np.arange(shape[3])[None, :]
    return np.where(cols < np.asarray(keep)[:, None], 0.0,
                    -1e9).astype(np.float32)


@pytest.mark.parametrize("name,shape,causal,keep", SOFTMAX_CASES,
                         ids=[c[0] for c in SOFTMAX_CASES])
def test_attn_softmax_kernels_match_jax(name, shape, causal, keep):
    """Forward and backward at 1e-5, with the TPU kernel's masking: causal
    scores replaced by -1e7 after the pad mask is added, and Lk padded to a
    multiple of 128.  A row that sees no key is uniform over the padded
    width, 1/128 at Lk = 70; a batch row whose pad mask hides every key is
    0 at Lk = 200 (the padded columns win the max) and uniform at 256."""
    x, dp = arrays(2, shape, shape)
    mask = pad_mask(shape, keep)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax_sm_fwd(jnp.asarray(x), jmask, mask_future=causal,
                      interpret=True)
    want_dx = jax_sm_bwd(want, jnp.asarray(dp), interpret=True)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = attn_softmax_forward(torch.from_numpy(x), tmask,
                               mask_future=causal)
    got_dx = attn_softmax_backward(torch.from_numpy(np.array(want)),
                                   torch.from_numpy(dp))
    close(got, want, **TIGHT)
    close(got_dx, want_dx, **TIGHT)
    Lq, Lk = shape[2], shape[3]
    if causal and Lq > Lk:
        torch.testing.assert_close(got[:, :, :Lq - Lk],
                                   torch.full_like(got[:, :, :Lq - Lk],
                                                   1 / 128))
    if keep is not None and not causal:
        hidden = got[1]
        expect = 0.0 if Lk % 128 else 1 / Lk
        torch.testing.assert_close(hidden, torch.full_like(hidden, expect))


@pytest.mark.parametrize("op", ["layernorm", "softmax"])
def test_kernels_keep_bf16(op):
    """bf16 inputs: arithmetic in fp32, outputs rounded to bf16 (the JAX
    kernels' dtype rule); within one bf16 ulp of the JAX kernels."""
    if op == "layernorm":
        x, g, b = arrays(3, (37, 200), (200,), (200,))
        jx = jnp.asarray(x, jnp.bfloat16)
        want = jax_ln_fwd(jx, jnp.asarray(g, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16), interpret=True)[0]
        tx = torch.from_numpy(x).bfloat16()
        got = layernorm_forward(tx, torch.from_numpy(g).bfloat16(),
                                torch.from_numpy(b).bfloat16())[0]
    else:
        (x,) = arrays(3, (2, 3, 130, 70))
        jx = jnp.asarray(x, jnp.bfloat16)
        want = jax_sm_fwd(jx, None, mask_future=True, interpret=True)
        got = attn_softmax_forward(torch.from_numpy(x).bfloat16(),
                                   mask_future=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, want, **BF16)


def test_kernel_impl_needs_cuda_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_forward(x, torch.ones(8), torch.zeros(8), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        attn_softmax_forward(x[None, None], impl="kernel")


# --- the differentiable ops ------------------------------------------------

def test_fused_op_gradients_match_jax_grad():
    """attn_softmax (causal, pad mask) and layer_norm: outputs and every
    gradient against jax.grad of the JAX ops on their Pallas route, 1e-5."""
    x, dout, ln_x, g, b, dy = arrays(4, (2, 3, 40, 70), (2, 3, 40, 70),
                                     (5, 7, 96), (96,), (96,), (5, 7, 96))
    mask = pad_mask((2, 3, 40, 70), (60, 30))

    def jsm(x):
        return jnp.sum(jax_attn_softmax(x, jnp.asarray(mask),
                                        mask_future=True, impl="pallas")
                       * dout)

    def jln(x, g, b):
        return jnp.sum(jax_layer_norm(x, g, b, impl="pallas") * dy)

    want_sm = jax.grad(jsm)(jnp.asarray(x))
    want_ln = jax.grad(jln, (0, 1, 2))(*map(jnp.asarray, (ln_x, g, b)))
    tx = torch.from_numpy(x).requires_grad_()
    out = fused.attn_softmax(tx, torch.from_numpy(mask), mask_future=True)
    (out * torch.from_numpy(dout)).sum().backward()
    close(tx.grad, want_sm, **TIGHT)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (ln_x, g, b)]
    (fused.layer_norm(*leaves) * torch.from_numpy(dy)).sum().backward()
    for leaf, w in zip(leaves, want_ln):
        close(leaf.grad, w, **TIGHT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_route_above_512(dtype):
    """Above the 512 limits ``impl=None`` takes the composed fp32 route on
    both sides: fp32 results from bf16 inputs, the causal mask added (not
    replaced), values at 1e-5 on the same (bf16-rounded) inputs and, in
    fp32, gradients at 1e-5.  At 512 and below the kernel route keeps the
    input dtype."""
    x, dout, ln_x, g, b, dy = arrays(5, (1, 2, 3, 640), (1, 2, 3, 640),
                                     (6, 640), (640,), (640,), (6, 640))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfn(x, lx, g, b):
        p = jax_attn_softmax(x, mask_future=True)
        y = jax_layer_norm(lx, g, b)
        return jnp.sum(p * dout) + jnp.sum(y * dy), (p, y)

    jargs = [jnp.asarray(a, jdt) for a in (x, ln_x, g, b)]
    (_, (jp, jy)), jgrads = jax.value_and_grad(jfn, (0, 1, 2, 3),
                                               has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).to(tdt).requires_grad_()
             for a in (x, ln_x, g, b)]
    tp = fused.attn_softmax(targs[0], mask_future=True)
    ty = fused.layer_norm(*targs[1:])
    assert tp.dtype == ty.dtype == torch.float32
    assert jp.dtype == jy.dtype == jnp.float32
    close(tp, jp, **TIGHT)
    close(ty, jy, **TIGHT)
    if dtype == "float32":
        ((tp * torch.from_numpy(dout)).sum()
         + (ty * torch.from_numpy(dy)).sum()).backward()
        for leaf, w in zip(targs, jgrads):
            close(leaf.grad, w, **TIGHT)
    small = torch.from_numpy(x[..., :512]).to(tdt)
    assert fused.attn_softmax(small).dtype == tdt
    assert fused.layer_norm(small[0, 0], targs[2][:512],
                            targs[3][:512]).dtype == tdt


def test_forced_kernel_route_and_stats_above_512():
    """``impl="plain"`` takes the kernel route at any size (the TPU
    kernel's replaced causal mask: rows sum to 1 over visible keys), and
    ``layer_norm_with_stats`` returns the kernel's (y, mean, var)."""
    x, g, b = arrays(6, (1, 1, 4, 640), (640,), (640,))
    tx = torch.from_numpy(x)
    forced = fused.attn_softmax(tx, mask_future=True, impl="plain")
    torch.testing.assert_close(forced, attn_softmax_forward(
        tx, mask_future=True))
    y, mean, var = fused.layer_norm_with_stats(
        tx[0, 0], torch.from_numpy(g), torch.from_numpy(b))
    jy, jmean, jvar = jax_ln_fwd(*map(jnp.asarray, (x[0, 0], g, b)),
                                 interpret=True)
    for a, w in zip((y, mean, var), (jy, jmean, jvar)):
        close(a, w, **TIGHT)


@pytest.mark.parametrize("op", ["softmax", "layernorm"])
def test_backward_oracles_match_jax(op):
    """The composed backward oracles of ``ops.reference`` against the JAX
    package's at 1e-5, from the same forward residuals, and against the
    kernels' plain backward, the same fp32 function."""
    if op == "softmax":
        x, dp = arrays(11, (2, 3, 40, 70), (2, 3, 40, 70))
        p = jax_ref.attn_softmax_reference(jnp.asarray(x), mask_future=True)
        want = [jax_ref.attn_softmax_bw_reference(p, jnp.asarray(dp))]
        args = (torch.from_numpy(np.array(p)), torch.from_numpy(dp))
        got = [torch_ref.attn_softmax_bw_reference(*args)]
        plain = [attn_softmax_backward(*args)]
    else:
        x, g, b, dy = arrays(12, (5, 7, 96), (96,), (96,), (5, 7, 96))
        _, mean, var = jax_ref.layernorm_fw_reference(
            *map(jnp.asarray, (x, g, b)))
        want = jax_ref.layernorm_bw_reference(
            *map(jnp.asarray, (dy, x, g)), mean, var)
        args = (*map(torch.from_numpy, (dy, x, g)),
                torch.from_numpy(np.array(mean)),
                torch.from_numpy(np.array(var)))
        got = torch_ref.layernorm_bw_reference(*args)
        plain = layernorm_backward(*args)
    for a, w, pl in zip(got, want, plain):
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        close(a, w, **TIGHT)
        close(a, pl, **TIGHT)


# --- the model -------------------------------------------------------------

def tree_np(tree):
    return {n: np.asarray(x, np.float32)
            for n, x in tnn.named_tree_leaves(tree)}


def grads_as_jax(model):
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, tnn.Linear)}
    return {n: (p.grad.T if n in linear else p.grad).numpy()
            for n, p in model.named_parameters()}


def torch_model(**over):
    cfg = {**CFG, "use_fused_kernel": True, **over}
    return tnn.DecoderLM(tnn.DecoderConfig(**cfg), device="cpu")


def make_pair(**over):
    cfg = {**CFG, "use_fused_kernel": True, **over}
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = torch_model(**over)
    tnn.load_jax_params(tm, params)
    return jm, params, tm


def batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, CFG["n_vocab"], (B, L)),
            "labels": rng.integers(0, CFG["n_vocab"], (B, L)),
            "label_token_weights": (rng.random((B, L)) > 0.3
                                    ).astype(np.float32)}


def jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in b.items()}


@pytest.mark.parametrize("kind", ["fused", "flash"])
def test_fused_model_logits_loss_and_gradients_match_jax(kind):
    """attention_kind ``kind`` with use_fused_kernel=True: logits, the
    masked-MLE loss and every gradient at 1e-5 from the same parameters;
    the fused LayerNorm is on every LN (eps 1e-8 although ln_eps is
    1e-5)."""
    jm, params, tm = make_pair(attention_kind=kind)
    data = batch()
    ids = data["input_ids"]
    want = jax.jit(jm)(params, jnp.asarray(ids, jnp.int32))
    close(tm(torch.from_numpy(ids)), want, **TIGHT)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jmt.make_loss_fn(jm)))(
        params, jax_batch(data))
    tm.zero_grad()
    loss = tmt.make_loss_fn(tm)(tmt.place_batch(data, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TIGHT)
    got, want_g = grads_as_jax(tm), tree_np(grads_j)
    assert got.keys() == want_g.keys()
    for n in want_g:
        np.testing.assert_allclose(got[n], want_g[n], err_msg=n, **TIGHT)
    assert all(m.fused for m in tm.modules() if isinstance(m, tnn.LayerNorm))


def test_fused_model_sgd_step_matches_jax():
    """One SGD step of make_train_step on the fused model: loss at 1e-5,
    every updated parameter at 1e-6."""
    jm, params, tm = make_pair(attention_kind="fused")
    data = batch(8)
    jopt, topt = jnn.sgd(lr=0.1), tnn.sgd(lr=0.1)
    new_j, _, loss_j = jmt.make_train_step(jm, jopt)(
        params, jopt.init(params), jax_batch(data), jax.random.key(1))
    step = tmt.make_train_step(tm, topt)
    _, loss = step(topt.init(dict(tm.named_parameters())),
                   tmt.place_batch(data, "cpu"))
    np.testing.assert_allclose(float(loss), float(loss_j), **TIGHT)
    got, want = tree_np(tnn.to_jax_params(tm)), tree_np(new_j)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP)


def test_fused_model_gqa_and_pad_mask_match_jax():
    """GQA (4 query heads on 2 KV heads, each KV head repeated before the
    scores) with a pad mask that hides the last keys of one sequence:
    logits at 1e-5."""
    jm, params, tm = make_pair(attention_kind="fused", n_kv_head=2)
    ids = batch(9)["input_ids"]
    mask = pad_mask((B, 1, L, L), (L, 40))
    want = jax.jit(lambda p, i, m: jm(p, i, kv_mask=m))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    got = tm(torch.from_numpy(ids), kv_mask=torch.from_numpy(mask))
    close(got, want, **TIGHT)


def test_bf16_model_above_512_takes_fp32_activations():
    """A bf16 model with E = 640 and use_fused_kernel: the composed LN
    route gives fp32 activations, the Linear layers compute in the promoted
    dtype, and the logits come out fp32 as in the JAX package (values
    within bf16 rounding, 5e-2)."""
    over = dict(n_embd=640, n_head=4, n_layer=1, ff_middle_dim=64,
                attention_kind="fused")
    cfg = {**CFG, **over, "use_fused_kernel": True}
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg, dtype=jnp.bfloat16))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**cfg, dtype=torch.bfloat16),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    ids = batch(10)["input_ids"][:, :8]
    want = jax.jit(jm)(params, jnp.asarray(ids, jnp.int32))
    got = tm(torch.from_numpy(ids))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want, atol=5e-2, rtol=5e-2)


def test_fused_attention_refuses_window_and_segment_ids():
    """The JAX package's own refusals on the fused branch."""
    ids = torch.zeros(1, 4, dtype=torch.long)
    tm = torch_model(attention_kind="fused", window=4)
    with pytest.raises(NotImplementedError, match="window is not expressible"):
        tm(ids)
    tm = torch_model(attention_kind="fused")
    with pytest.raises(NotImplementedError,
                       match="segment_ids is not expressible"):
        tm(ids, segment_ids=torch.zeros_like(ids))


def test_fused_ln_model_weights_round_trip():
    """load_jax_params then to_jax_params gives the JAX tree back exactly:
    the fused LayerNorm keeps the names gamma and beta."""
    _, params, tm = make_pair(attention_kind="fused")
    got, want = tree_np(tnn.to_jax_params(tm)), tree_np(params)
    assert got.keys() == want.keys()
    assert any(n.endswith("ln_1.gamma") for n in want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_cpu_model_launches_no_kernel():
    """On CPU tensors every fused op takes its plain version."""
    tm = torch_model(attention_kind="fused")
    before = dict(common.launch_counts)
    tm(torch.zeros(1, 8, dtype=torch.long)).sum().backward()
    assert dict(common.launch_counts) == before
