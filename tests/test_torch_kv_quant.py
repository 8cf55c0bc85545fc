"""Quantized-K/V training in the port against the JAX package, on the CPU.

The port's quantizer (``ops.quantize_kv``) against JAX's ``_quantize_kv``
bit for bit (int8 codes and scales, fp8 codes, all-zero rows and channels,
token and channel granularity); the flash kernels' plain versions on codes
and scales (forward, fused backward, both two-pass halves) against JAX's
``flash_attention_forward`` / ``_backward`` (Pallas in interpret mode, as
its own tests run it) per token and per channel, ``"ld"`` and ``"dl"``
codes, fp32 and bf16, GQA; ``ops.flash_attention(kv_quant=m)`` forward and
gradients against JAX's op for the four modes, the saved tensors being
codes; the JAX package's int8 cases with dropout, with a window, and with
segments, window and dropout at once; ``DecoderLM`` with ``kv_quant`` on
the flash route and on ``"auto"`` below the crossover against the JAX model
with the same parameters (``load_jax_params``); the quantized C entries'
arguments (their library stubbed); and what raises.  Inputs come from a
numpy seed.

Tolerances: fp32 at 1e-5 (module) and the kernels' plain versions at 1e-4;
bf16 forward 1e-3 (and one bf16 ulp of out) and backward 1e-2.  fp8 codes: the port converts e4m3 to
bf16 exactly, subnormals kept, where JAX's ``fp8_e4m3_to_bf16`` flushes
codes below 2**-6 to 0 (ROADMAP.md, deviations); with per-token scales
those codes are values under 2**-6 * amax / 448 of their row, and the
outputs move by ~1e-6, inside 1e-5; per channel a code is subnormal where
the value is small against its channel's amax over the sequence, which is
common, and the fp8-channel outputs and gradients are held at 2e-4
(measured ~1e-5 at these shapes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_flash
from tpu_flash import nn as jnn
from tpu_flash.kernels import flash_attention as jfa
from tpu_flash.ops import attention as jops
from tpu_flash_torch import nn as tnn
from tpu_flash_torch import ops as tops
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)
KERNEL_F32 = dict(atol=1e-4, rtol=1e-4)
# bf16 out: 1e-3, and one bf16 ulp (2**-8 of |out|) where the two sums
# round to neighbouring bf16 values
FW_BF16 = dict(atol=1e-3, rtol=2 ** -8)
BW_BF16 = dict(atol=1e-2, rtol=1e-2)
FP8_CHANNEL = dict(atol=2e-4, rtol=2e-4)
MODES = ("int8", "fp8", "int8_channel", "fp8_channel")


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def tol_of(mode):
    return FP8_CHANNEL if mode == "fp8_channel" else F32


# --- the quantizer -------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quantizer_matches_jax_bit_for_bit(rng, mode):
    """Codes and fp32 scales equal JAX's, with an all-zero position (token
    scale 1) and an all-zero channel (channel scale 1), ties of int8
    rounding (half to even) and values near the e4m3 range's top."""
    x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32) * 3
    x[0, 1, 7] = 0.0                      # a zero row: token scale 1
    x[1, 2, :, 5] = 0.0                   # a zero channel: channel scale 1
    x[1, 0, 3, :4] = [63.5, -63.5, 127.0, 0.5]   # int8 ties at scale 1
    x[1, 0, 3, 4:] = 0.0
    want_c, want_s = jops._quantize_kv(jnp.asarray(x), mode)
    got_c, got_s = tops.quantize_kv(torch.from_numpy(x), mode)
    assert got_c.dtype == (torch.int8 if mode.startswith("int8")
                           else torch.float8_e4m3fn)
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(np32(got_c), np32(want_c))
    assert (got_s > 0).all()
    back = tops.dequantize_kv(got_c, got_s, mode)
    if mode.startswith("int8"):
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jops.dequantize_kv(want_c, want_s,
                                                        mode)))
    assert float((back - torch.from_numpy(x)).abs().max()) < 0.1 * abs(
        x).max()


# --- the plain kernels against JAX's ---------------------------------------------

# mode, layout, dtype, B, H, Hkv, L, d, window
KERNEL_CASES = [
    ("int8", "ld", torch.float32, 1, 2, 2, 128, 32, None),
    ("fp8", "dl", torch.float32, 1, 2, 1, 192, 32, None),       # GQA
    ("int8_channel", "ld", torch.float32, 1, 2, 2, 192, 32, 48),
    ("fp8_channel", "dl", torch.float32, 1, 2, 1, 128, 32, None),
    ("int8_channel", "dl", torch.bfloat16, 1, 2, 2, 128, 32, None),
    # bf16 below d = 128 with token scales: the normaliser sums the fp32 P
    # (JAX's fold_l off); the bf16 P's sum would move lse by ~1e-3
    ("int8", "ld", torch.bfloat16, 1, 2, 2, 192, 64, None),
]


@pytest.mark.parametrize("mode,layout,dtype,B,H,Hkv,L,d,window",
                         KERNEL_CASES)
def test_plain_kernels_match_jax_kernels(rng, mode, layout, dtype, B, H,
                                         Hkv, L, d, window):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, L, d), (B, Hkv, L, d), (B, Hkv, L, d), (B, H, L, d))]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jdo = jnp.asarray(arrays[0], jdt), jnp.asarray(arrays[3], jdt)
    gran = tops.attention.kv_quant_parts(mode)[1]
    (jkc, jks), (jvc, jvs) = (jops._quantize_kv(jnp.asarray(a), mode)
                              for a in arrays[1:3])
    (kc, ks), (vc, vs) = (tops.quantize_kv(torch.from_numpy(a), mode)
                          for a in arrays[1:3])
    if layout == "dl":
        jkc, jvc = jkc.transpose(0, 1, 3, 2), jvc.transpose(0, 1, 3, 2)
        kc, vc = kc.transpose(-1, -2), vc.transpose(-1, -2)
    kw = dict(causal=True, window=window, kv_layout=layout,
              kv_scale_mode=gran)
    jout, jlse, _ = jfa.flash_attention_forward(jq, jkc, jvc, jks, jvs, **kw)
    jgrads = jfa.flash_attention_backward(jq, jkc, jvc, jout, jlse, jdo,
                                          None, jks, jvs, **kw)
    q, do = (torch.from_numpy(a).to(dtype) for a in (arrays[0], arrays[3]))
    tkw = dict(kw, k_scale=ks, v_scale=vs)
    out, lse, _ = tfa.flash_attention_forward(q, kc, vc, **tkw)
    fused = tfa.flash_attention_backward_fused(q, kc, vc, out, lse, do,
                                               **tkw)
    two = tfa.flash_attention_backward_two_pass(q, kc, vc, out, lse, do,
                                                **tkw)
    if dtype == torch.float32:
        fw = bw = FP8_CHANNEL if mode == "fp8_channel" else KERNEL_F32
    else:
        fw, bw = FW_BF16, BW_BF16
    np.testing.assert_allclose(np32(out), np32(jout), **fw)
    np.testing.assert_allclose(np32(lse), np32(jlse), **fw)
    for got in (fused, two):
        for g, w in zip(got, jgrads):
            assert g.dtype == dtype
            np.testing.assert_allclose(np32(g), np32(w), **bw)
    if dtype == torch.bfloat16 and gran == "token":
        # lse is JAX's to 2e-4 of the undropped fp32 P's sum; summing the
        # bf16 P (the unquantized rule below d = 128) would miss it
        np.testing.assert_allclose(np32(lse), np32(jlse), atol=2e-4, rtol=0)


def test_entry_checks_match_jax_messages():
    q = torch.zeros(1, 2, 16, 32)
    codes = torch.zeros(1, 2, 16, 32, dtype=torch.int8)
    s = torch.ones(1, 2, 16)
    for kw, match in ((dict(kv_scale_mode="row"), "kv_scale_mode must be"),
                      (dict(kv_layout="ll"), "kv_layout must be")):
        for fn in (lambda: tfa.flash_attention_forward(
                q, codes, codes, k_scale=s, v_scale=s, **kw),
                   lambda: tfa.flash_attention_backward(
                q, codes, codes, q, s, q, k_scale=s, v_scale=s, **kw)):
            with pytest.raises(ValueError, match=match):
                fn()
    with pytest.raises(ValueError, match="k_scale must be"):
        tfa.flash_attention_forward(q, codes, codes, k_scale=s, v_scale=s,
                                    kv_scale_mode="channel")
    with pytest.raises(TypeError, match="codes"):
        tfa.flash_attention_forward(q, q, q, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention_forward(q, codes, codes, k_scale=s)


# --- the C entries' arguments ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["fp8", "int8_channel"])
def test_quantized_launches_take_their_entries(monkeypatch, dtype, mode):
    """Each launcher with quantized K/V calls ``tf_<form>_kvq`` of its
    source's ``_kvq`` library with the unquantized entry's arguments, then
    the token scales' pointers (None per channel) and the e4m3 flag, one
    argument per declared type, and counts the form under its KVQ name."""
    calls = []

    def fake_entry(source, symbol, argtypes):
        calls.append((source, symbol, argtypes))
        return None, lambda *a: calls.append(a) or 0

    monkeypatch.setattr(tfa, "entry", fake_entry)
    monkeypatch.setattr(tfa, "call_on_stream",
                        lambda fn, device, *a: fn(*a, None))
    gran = tops.attention.kv_quant_parts(mode)[1]
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(1, 4, 24, 32, generator=g).to(dtype)
             for _ in range(2))
    kc, ks = tops.quantize_kv(torch.randn(1, 2, 24, 32, generator=g), mode)
    vc, vs = tops.quantize_kv(torch.randn(1, 2, 24, 32, generator=g), mode)
    kvq = tfa.KvQuant(gran, ks, vs).inside()
    lse = torch.zeros(1, 4, 24)
    kin = (*tfa._delta_inputs(q, kc, vc, lse, do, torch.zeros(1, 4, 24),
                              True), True, 0.25, 0, None, None, None, kvq)
    launches = {
        "fwd": lambda: tfa._launch_forward(q, kc, vc, True, None, None,
                                           False, None, None, None, kvq),
        "bwd": lambda: tfa._launch_backward(*kin),
        "bwd_dkv": lambda: tfa._launch_dkv(*kin),
        "bwd_dq": lambda: tfa._launch_dq(*kin)}
    for which, launch in launches.items():
        calls.clear()
        before = dict(common.launch_counts)
        launch()
        (source, symbol, argtypes), args = calls
        form = tfa._form_name("flash_attention_" + which, dtype)
        assert symbol == "tf_" + form + "_kvq"
        library = (tfa.SOURCE_TWO_PASS if which.startswith("bwd_")
                   else "flash_attention_" + which)
        assert source == library + tfa.KVQ[gran]
        assert len(args) == len(argtypes)
        token = gran == "token"
        assert args[-4:-1] == ((ks.data_ptr() if token else None),
                               (vs.data_ptr() if token else None),
                               int(mode.startswith("fp8")))
        after = {n: c - before.get(n, 0) for n, c in
                 common.launch_counts.items() if c != before.get(n, 0)}
        assert after == {tfa._form_name("flash_attention_" + which, dtype,
                                        quant=gran): 1}


# --- the op ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_op_matches_jax(rng, mode):
    """``flash_attention(kv_quant=m)``: output and gradients against JAX's
    op (causal, B1 H2 L128 d32), and the saved tensors are the codes (int8
    or e4m3) and fp32 scales, not K and V (JAX's ``res[1].dtype``)."""
    q, k, v, w = (rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
                  for _ in range(4))
    jfn = lambda q, k, v: jnp.sum(tpu_flash.flash_attention(
        q, k, v, causal=True, kv_quant=mode, impl="pallas") * w)
    jout = tpu_flash.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, kv_quant=mode,
        impl="pallas")
    jgrads = jax.grad(jfn, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=True, kv_quant=mode)
    saved = out.grad_fn.saved_tensors
    code = torch.int8 if mode.startswith("int8") else torch.float8_e4m3fn
    assert [t.dtype for t in saved[1:5]] == [code, torch.float32, code,
                                             torch.float32]
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(np32(out), np32(jout), **tol_of(mode))
    for x, g in zip(leaves, jgrads):
        np.testing.assert_allclose(np32(x.grad), np32(g), **tol_of(mode))


def test_dropout_with_int8_kv(rng):
    """The JAX package's case (tests/test_attention_dropout.py:142):
    dropout composes with int8-K/V training attention (it changes the
    output, the gradients are finite and track the unquantized ones), and
    the port's forward and gradients are JAX's with the same seed."""
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, kv_quant="int8", dropout_rate=0.2,
              dropout_seed=21)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = tpu_flash.flash_attention(jq, jk, jv, **kw)
    jgrads = jax.grad(lambda *a: jnp.sum(tpu_flash.flash_attention(
        *a, **kw) * do), (0, 1, 2))(jq, jk, jv)

    def run(**over):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tops.flash_attention(*leaves, **{**kw, **over})
        out.backward(torch.from_numpy(do))
        return out, [x.grad for x in leaves]

    out, grads = run()
    base, _ = run(dropout_rate=0.0)
    _, grads_fp = run(kv_quant="none")
    assert float((out - base).detach().abs().max()) > 0
    np.testing.assert_allclose(np32(out), np32(jout), **F32)
    for g, jg, gf in zip(grads, jgrads, grads_fp):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(np32(g), np32(jg), **F32)
        np.testing.assert_allclose(np32(g), np32(gf), rtol=0.2, atol=0.05)


@pytest.mark.parametrize("extra", [dict(window=64),
                                   dict(window=32, segments=True,
                                        dropout_rate=0.2, dropout_seed=3)])
def test_window_segments_dropout_with_int8_kv(rng, extra):
    """The JAX package's int8 cases under a window
    (tests/test_window_attention.py:157: within 5e-2 of the unquantized
    window) and under packed segments, a window and dropout at once
    (tests/test_packing.py:54): the port's forward and gradients are JAX's
    op's (causal, B1 H2 L192 d64)."""
    B, H, L, d = 1, 2, 192, 64
    q, k, v, w = (rng.standard_normal((B, H, L, d)).astype(np.float32) * 0.5
                  for _ in range(4))
    extra = dict(extra)
    seg = None
    if extra.pop("segments", False):
        seg = np.repeat(np.arange(8, dtype=np.int32), 24)[None]
    kw = dict(causal=True, kv_quant="int8", **extra)
    jkw = dict(kw, segment_ids=None if seg is None else jnp.asarray(seg))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = tpu_flash.flash_attention(jq, jk, jv, **jkw)
    jgrads = jax.grad(lambda *a: jnp.sum(tpu_flash.flash_attention(
        *a, **jkw) * w), (0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tkw = dict(kw, segment_ids=None if seg is None
               else torch.from_numpy(seg))
    out = tops.flash_attention(*leaves, **tkw)
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(np32(out), np32(jout), **F32)
    for x, g in zip(leaves, jgrads):
        np.testing.assert_allclose(np32(x.grad), np32(g), **F32)
    if seg is None:
        base = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=True, window=extra["window"])
        np.testing.assert_allclose(np32(out), np32(base), atol=5e-2,
                                   rtol=5e-2)


# --- the model ------------------------------------------------------------------

CFG = dict(n_vocab=64, n_embd=64, n_head=4, n_positions=48, n_layer=1,
           p_dropout=0.0)


@pytest.mark.parametrize("kind,mode", [("flash", "int8"),
                                       ("auto", "int8"),
                                       ("auto", "fp8_channel")])
def test_model_matches_jax(rng, kind, mode):
    """``DecoderLM`` with ``kv_quant`` against the JAX model with the same
    parameters: the logits and the gradient of every parameter, on the
    flash route (the quantized kernels) and on ``"auto"`` below
    ``_FLASH_AUTO_MIN_L`` (the composed graph on straight-through
    dequantized K/V); the two routes agree to the JAX test's 2e-2 on the
    loss."""
    cfg = dict(CFG, attention_kind=kind, kv_quant=mode)
    jm = jnn.DecoderLM(jnn.DecoderConfig(**cfg))
    params = jm.init(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**cfg), device="cpu")
    tnn.load_jax_params(tm, params)
    ids = rng.integers(0, 64, (2, 48))

    def jloss(p):
        logits = jm(p, jnp.asarray(ids, jnp.int32))
        return jnp.mean(logits ** 2), logits

    (jval, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    logits = tm(torch.from_numpy(ids))
    loss = logits.square().mean()
    loss.backward()
    np.testing.assert_allclose(np32(logits), np32(jlogits), **tol_of(mode))
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-5)
    want = {n: np.asarray(x, np.float32)
            for n, x in tnn.named_tree_leaves(jgrads)}
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, tnn.Linear)}
    got = {n: np32(p.grad.T if n in linear else p.grad)
           for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n,
                                   **tol_of(mode))
    flash = tnn.DecoderLM(tnn.DecoderConfig(**dict(cfg,
                                                   attention_kind="flash")),
                          device="cpu")
    flash.load_state_dict(tm.state_dict())
    other = float(flash(torch.from_numpy(ids)).square().mean())
    assert abs(other - float(loss)) < 2e-2 * max(1.0, abs(other))


def test_model_kv_quant_training_step_lowers_the_loss(rng):
    """The JAX package's ``test_decoder_kv_quant_training``: int8 K/V in
    the model stay within 5 % of the unquantized logits, every gradient is
    finite, the q projection's is not zero, and one Adam step lowers the
    loss."""
    base = tnn.DecoderConfig(**CFG)
    model = tnn.DecoderLM(base, device="cpu")
    tnn.init_params(model, torch.Generator().manual_seed(0))
    qmodel = tnn.DecoderLM(dataclasses.replace(base, kv_quant="int8"),
                           device="cpu")
    qmodel.load_state_dict(model.state_dict())
    ids = torch.from_numpy(rng.integers(0, 64, (2, 32)))
    out, qout = model(ids), qmodel(ids)
    assert float((qout - out).norm() / out.norm()) < 0.05
    tgt = torch.from_numpy(rng.integers(0, 64, (2, 32)))

    def loss_fn():
        return torch.nn.functional.cross_entropy(
            qmodel(ids).flatten(0, 1), tgt.flatten())

    loss = loss_fn()
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in qmodel.parameters())
    gq = qmodel.layers[0].attention.q_projection.weight.grad
    assert float(gq.abs().max()) > 0
    opt = torch.optim.Adam(qmodel.parameters(), lr=1e-2)
    opt.step()
    assert float(loss_fn()) < float(loss)


def test_dense_routes_refuse_kv_quant():
    """JAX's ValueErrors (nn/transformer.py:117-121): the dense graphs have
    no quantized-K/V form, and an unknown mode is refused by the config and
    the op."""
    for kind in ("naive", "fused"):
        with pytest.raises(ValueError, match="kv_quant requires the flash"):
            tnn.DecoderConfig(attention_kind=kind, kv_quant="int8")
    with pytest.raises(ValueError, match="kv_quant"):
        tnn.DecoderConfig(attention_kind="flash", kv_quant="int4")
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="kv_quant must be"):
        tops.flash_attention(q, q, q, kv_quant="int4")
    for kind in ("flash", "auto"):
        cfg = tnn.DecoderConfig(attention_kind=kind, kv_quant="fp8")
        assert cfg.kv_quant == "fp8"
