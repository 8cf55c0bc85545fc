"""The two-pass backward's launch plan (``kernels/flash_attention.py``
``_form_name``), which runs here without a card: bf16 takes the
tensor-core form and counts its launches under the kernels' names + ``_tc``,
fp32 the six-product form under the names + ``_x6``; each form calls its
own C entry
and counts one launch where that entry returns success, none where it
fails; and ``flash_attention_backward`` still takes the two passes exactly
where ``backward_form.two_pass`` (the JAX package's rule) says, mode (f)'s
shape among them.  The C entries are replaced by stubs that record their
call, or the launch functions by their plain halves that count as the
launches would, as a CPU rehearsal of ``chip_smoke.py`` replaces them."""

import math

import numpy as np
import pytest
import torch

from tpu_flash_torch.kernels import backward_form, common
from tpu_flash_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

BF16, FP32 = torch.bfloat16, torch.float32
NAMES = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def inputs(dtype, B=1, H=2, Hkv=1, Lq=40, Lk=40, d=16, causal=True, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Lq, d))).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Lk, d))).to(dtype)
            for _ in range(2))
    out, lse, _ = fa.flash_attention_forward(q, k, v, causal=causal,
                                             impl="plain")
    return q, k, v, out, lse, do


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel route on CPU tensors, each pass's launch replaced by its
    plain half, counting under the launch's name (the rehearsal's
    stand-in)."""
    def counted(kernel, plain):
        def launch(q, *a):
            common.launch_counts[fa._form_name(kernel, q.dtype)] += 1
            return plain(q, *a)
        return launch

    monkeypatch.setattr(fa, "resolve_impl", lambda impl, x: impl or "kernel")
    monkeypatch.setattr(fa, "_launch_dkv",
                        counted(fa.KERNEL_DKV, fa._dkv_plain))
    monkeypatch.setattr(fa, "_launch_dq", counted(fa.KERNEL_DQ, fa._dq_plain))


def counts_of(run):
    before = dict(common.launch_counts)
    out = run()
    return out, {n: common.launch_counts[n] - before.get(n, 0)
                 for n in common.launch_counts
                 if common.launch_counts[n] != before.get(n, 0)}


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_the_form_follows_the_dtype(dtype, suffix, d):
    q = torch.zeros(1, 1, 8, d, dtype=dtype)
    assert [fa._form_name(n, q.dtype) for n in NAMES] == [
        n + suffix for n in NAMES]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_launches_count_under_the_forms_names(plain_launches, dtype, suffix,
                                              d):
    args = inputs(dtype, d=d)
    got, launched = counts_of(
        lambda: fa.flash_attention_backward_two_pass(*args, causal=True))
    assert launched == {n + suffix: 1 for n in NAMES}
    want = fa.flash_attention_backward_two_pass(*args, causal=True,
                                                impl="plain")
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["dkv", "dq"])
@pytest.mark.parametrize("dtype,symbol_suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_each_form_calls_its_own_c_entry(monkeypatch, which, dtype,
                                         symbol_suffix):
    """``_launch_dkv`` / ``_launch_dq`` call ``tf_flash_attention_bwd_<pass>``
    + ``_tc`` for bf16 and + ``_x6`` for fp32, with dtype flag 1 or 0 and
    the pointers of the outputs they return."""
    calls = []

    def fake_entry(source, symbol, argtypes):
        assert source == fa.SOURCE_TWO_PASS
        return None, lambda *a: calls.append((symbol, a)) or 0

    monkeypatch.setattr(fa, "entry", fake_entry)
    monkeypatch.setattr(fa, "call_on_stream",
                        lambda fn, device, *a: fn(*a, None))
    q, k, v, out, lse, do = inputs(dtype, H=4, Hkv=2, Lq=24, Lk=40, d=32)
    kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True, 0.25, 16)
    outs, launched = counts_of(
        lambda: fa._launch_dkv(*kin) if which == "dkv"
        else (fa._launch_dq(*kin),))
    (symbol, a), = calls
    assert symbol == f"tf_flash_attention_bwd_{which}{symbol_suffix}"
    assert launched == {symbol[len("tf_"):]: 1}
    n_ptr = 8 if which == "dkv" else 7
    assert list(a[6:n_ptr]) == [t.data_ptr() for t in outs]
    ints = a[n_ptr:n_ptr + 9]      # B H Hkv Lq Lk d dtype causal q_offset
    assert ints == (1, 4, 2, 24, 40, 32, int(dtype == BF16), 1, 16)
    assert a[n_ptr + 9:n_ptr + 11] == (0.25, 0.25 * fa.LOG2E)
    assert [t.shape for t in outs] == ([k.shape, v.shape] if which == "dkv"
                                       else [q.shape])


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_a_failed_launch_raises_with_the_forms_name(monkeypatch, dtype):
    class Lib:
        @staticmethod
        def tf_cuda_error_string(code):
            return b"invalid argument"

    monkeypatch.setattr(fa, "entry", lambda *a: (Lib, lambda *x: 1))
    monkeypatch.setattr(fa, "call_on_stream", lambda fn, dev, *a: fn(*a))
    args = inputs(dtype)
    kin = (*fa._bwd_inputs(*args, None), True, 0.25, 0)
    name = "flash_attention_bwd_dkv" + ("_tc" if dtype == BF16 else "_x6")
    before = dict(common.launch_counts)
    with pytest.raises(RuntimeError, match=f"{name} kernel failed"):
        fa._launch_dkv(*kin)
    assert dict(common.launch_counts) == before     # nothing launched


@pytest.mark.parametrize("dtype,L,two", [
    (BF16, 16384, True),     # mode (f): B1 H8 L16384 d64 causal bf16
    (BF16, 2048, False),     # modes (a), (b), (e): the fused kernel
    (FP32, 8192, True),      # the fp32 long-two-pass step
    (FP32, 4096, False)])
def test_dispatch_follows_the_jax_rule(monkeypatch, dtype, L, two):
    """``flash_attention_backward`` at the attention shapes of the training
    modes (one head; the rule reads lengths, d and dtype only): the two
    passes in their dtype's form where ``backward_form.two_pass`` says so,
    the fused kernel elsewhere.  The launches are stubs that return
    zeros, so the shapes are the real ones."""
    assert backward_form.two_pass(L, L, 64, dtype.itemsize, True) == two
    monkeypatch.setattr(fa, "resolve_impl", lambda impl, x: impl or "kernel")

    def zeros_dkv(q, k, v, *a):
        common.launch_counts[fa._form_name(fa.KERNEL_DKV, q.dtype)] += 1
        return torch.zeros_like(k), torch.zeros_like(v)

    def zeros_dq(q, *a):
        common.launch_counts[fa._form_name(fa.KERNEL_DQ, q.dtype)] += 1
        return torch.zeros_like(q)

    def zeros_fused(q, k, v, *a):
        common.launch_counts[fa._form_name(fa.KERNEL_BWD, q.dtype)] += 1
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(fa, "_launch_dkv", zeros_dkv)
    monkeypatch.setattr(fa, "_launch_dq", zeros_dq)
    monkeypatch.setattr(fa, "_launch_backward", zeros_fused)
    q = torch.zeros(1, 1, L, 64, dtype=dtype)
    lse = torch.zeros(1, 1, L)
    _, launched = counts_of(lambda: fa.flash_attention_backward(
        q, q, q, q, lse, q, causal=True))
    suffix = "_tc" if dtype == BF16 else "_x6"
    fused = "_tc" if dtype == BF16 else "_x6"
    assert launched == ({n + suffix: 1 for n in NAMES} if two
                        else {fa.KERNEL_BWD + fused: 1})


def test_the_plain_halves_stand_in_for_both_forms_bit_for_bit(
        plain_launches):
    """Ragged lengths, GQA and q_offset either way through the stand-in:
    the same bits as the plain route (the rehearsal changes no number)."""
    for Lq, Lk, qo in ((37, 53, 9), (53, 37, -20)):
        q, k, v, out, lse, do = inputs(BF16, B=2, H=4, Hkv=2, Lq=Lq, Lk=Lk,
                                       d=32, causal=False)
        kw = dict(causal=True, q_offset=qo, scale=1 / math.sqrt(32))
        got = fa.flash_attention_backward_two_pass(q, k, v, out, lse, do,
                                                   **kw)
        want = fa.flash_attention_backward_two_pass(q, k, v, out, lse, do,
                                                    impl="plain", **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
