"""The launch plan of the flash-attention forward and fused backward
(``kernels/flash_attention.py`` ``_form_name``), which runs here without a
card: bf16 calls the tensor-core entries ``tf_flash_attention_{fwd,bwd}_tc``
and counts its launches under the kernels' names + ``_tc``, fp32 calls the
six-product entries ``tf_flash_attention_{fwd,bwd}_x6`` under the names +
``_x6``; each launcher counts one launch where its entry returns success
and none where it fails; the fused backward's dQ order holds one counter
per chunk of its form (64 query rows, and 32 in fp32 at d = 128); and
``flash_attention_backward`` still takes
the form ``backward_form.two_pass`` (the JAX package's rule) gives; a
window or segment ids launch the masked forms, dropout the dropout forms
with the seed's device pointer, the threshold and the scale.  The C
entries are stubs that record their call and return a code."""

import ctypes

import numpy as np
import pytest
import torch

from tpu_flash_torch.kernels import backward_form, common
from tpu_flash_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

BF16, FP32 = torch.bfloat16, torch.float32
SOURCES = {"fwd": fa.KERNEL_FWD, "bwd": fa.KERNEL_BWD}


def counts_of(run):
    before = dict(common.launch_counts)
    out = run()
    return out, {n: common.launch_counts[n] - before.get(n, 0)
                 for n in common.launch_counts
                 if common.launch_counts[n] != before.get(n, 0)}


def inputs(dtype, B=1, H=4, Hkv=2, Lq=40, Lk=72, d=32):
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Lq, d))).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Lk, d))).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.fixture
def stub_entries(monkeypatch):
    """Every C entry a stub that records (source, symbol, arguments) and
    returns ``codes[0]``; the launchers take the kernel route on CPU
    tensors."""
    calls, codes = [], [0]

    class Lib:
        @staticmethod
        def tf_cuda_error_string(code):
            return b"invalid argument"

    def fake_entry(source, symbol, argtypes):
        def fn(*a):
            calls.append((source, symbol, a))
            return codes[0]
        return Lib, fn

    monkeypatch.setattr(fa, "entry", fake_entry)
    monkeypatch.setattr(fa, "call_on_stream",
                        lambda fn, device, *a: fn(*a, None))
    monkeypatch.setattr(fa, "resolve_impl", lambda impl, x: impl or "kernel")
    return calls, codes


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_the_form_follows_the_dtype(dtype, suffix, d):
    q = torch.zeros(1, 1, 8, d, dtype=dtype)
    assert [fa._form_name(n, q.dtype) for n in SOURCES.values()] == [
        "flash_attention_fwd" + suffix, "flash_attention_bwd" + suffix]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_each_form_calls_its_own_c_entry(stub_entries, which, dtype, suffix):
    """The forward and the fused backward call ``tf_flash_attention_<which>``
    + ``_tc`` for bf16 and + ``_x6`` for fp32, in the kernel's source, with
    dtype flag 1 or 0 and the pointers of the outputs they return, and count
    one launch under the entry's name."""
    calls, _ = stub_entries
    q, k, v, do = inputs(dtype)
    if which == "fwd":
        outs, launched = counts_of(lambda: fa.flash_attention_forward(
            q, k, v, causal=True, q_offset=16, with_m=True))
        pointers = [t.data_ptr() for t in outs]
        n_ptr = 6
    else:
        out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True,
                                                 impl="plain")
        kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True, 0.25, 16)
        outs, launched = counts_of(lambda: fa._launch_backward(*kin))
        n_ptr = 10
    (source, symbol, a), = calls
    assert source == SOURCES[which]
    assert symbol == f"tf_flash_attention_{which}{suffix}"
    assert launched == {symbol[len("tf_"):]: 1}
    ints = a[n_ptr:n_ptr + 9]      # B H Hkv Lq Lk d dtype causal q_offset
    assert ints == (1, 4, 2, 40, 72, 32, int(dtype == BF16), 1, 16)
    if which == "fwd":
        assert list(a[3:6]) == pointers          # out, lse, m
        assert a[n_ptr + 9] == pytest.approx(fa.LOG2E / np.sqrt(32))
        assert outs[0].dtype == dtype and outs[0].shape == q.shape
    else:
        assert a[n_ptr + 9:n_ptr + 11] == (0.25, 0.25 * fa.LOG2E)
        assert [t.shape for t in outs] == [q.shape, k.shape, v.shape]
        assert all(t.dtype == dtype for t in outs)


@pytest.mark.parametrize("dtype,d,chunk", [
    (BF16, 32, 64), (BF16, 128, 64), (FP32, 32, 64), (FP32, 128, 32)])
@pytest.mark.parametrize("Lq", [40, 64, 130])
def test_the_dq_order_has_a_counter_per_chunk_of_the_form(
        stub_entries, monkeypatch, dtype, d, chunk, Lq):
    """dq_order (int32, zeroed) holds B * H * ceil(Lq / chunk) counters,
    chunk being the form's query tile (the fp32 form takes 32 rows at
    d = 128, where 64 would not fit its shared memory); the fp32 dQ
    workspace is zeroed [B, H, Lq, d]."""
    zeros = []
    real_zeros = torch.zeros

    def recording_zeros(*shape, **kw):
        t = real_zeros(*shape, **kw)
        zeros.append(t)
        return t

    monkeypatch.setattr(torch, "zeros", recording_zeros)
    q, k, v, do = inputs(dtype, B=2, Lq=Lq, d=d)
    lse = real_zeros(2, 4, Lq)
    kin = (*fa._bwd_inputs(q, k, v, q, lse, do, None), True, 0.25, 0)
    calls, _ = stub_entries
    fa._launch_backward(*kin)
    (_, _, a), = calls
    by_ptr = {t.data_ptr(): t for t in zeros}
    dq, order = by_ptr[a[6]], by_ptr[a[7]]
    assert dq.dtype == torch.float32 and dq.shape == (2, 4, Lq, d)
    assert order.dtype == torch.int32
    assert order.shape == (2 * 4 * -(-Lq // chunk),)
    assert not order.any() and not dq.any()


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_a_failed_launch_raises_with_the_forms_name(stub_entries, which,
                                                    dtype):
    _, codes = stub_entries
    codes[0] = 1
    q, k, v, do = inputs(dtype)
    name = f"flash_attention_{which}" + ("_tc" if dtype == BF16 else "_x6")
    before = dict(common.launch_counts)
    with pytest.raises(RuntimeError, match=f"{name} kernel failed"):
        if which == "fwd":
            fa.flash_attention_forward(q, k, v, causal=True)
        else:
            out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True,
                                                     impl="plain")
            fa.flash_attention_backward_fused(q, k, v, out, lse, do,
                                              causal=True)
    assert dict(common.launch_counts) == before     # nothing launched


@pytest.mark.parametrize("dtype,L,two", [
    (BF16, 2048, False),     # modes (b), (e): the fused kernel, tensor cores
    (FP32, 2048, False),     # mode (a): the fused kernel, six products
    (BF16, 16384, True),     # mode (f): the two passes
    (FP32, 8192, True)])
def test_the_training_shapes_take_the_jax_form(stub_entries, dtype, L, two):
    """A forward and a backward at the attention shapes of the training
    modes (one head; the rule reads lengths, d and dtype only) through the
    real launchers: the forward in its dtype's form, then the fused kernel
    or the two passes where ``backward_form.two_pass`` says so (in fp32 the
    forward, the fused kernel and the two passes take the six-product
    form)."""
    assert backward_form.two_pass(L, L, 64, dtype.itemsize, True) == two
    calls, _ = stub_entries
    q = torch.zeros(1, 1, L, 64, dtype=dtype)
    fused, passes = ("_tc", "_tc") if dtype == BF16 else ("_x6", "_x6")

    def step():
        out, lse, _ = fa.flash_attention_forward(q, q, q, causal=True)
        return fa.flash_attention_backward(q, q, q, out, lse, q, causal=True)

    grads, launched = counts_of(step)
    names = [fa.KERNEL_FWD + fused] + (
        [fa.KERNEL_DKV + passes, fa.KERNEL_DQ + passes] if two
        else [fa.KERNEL_BWD + fused])
    assert launched == {n: 1 for n in names}
    assert [c[1] for c in calls] == ["tf_" + n for n in names]
    assert [g.dtype for g in grads] == [dtype] * 3


def test_the_c_entries_take_ctypes_of_the_right_width(stub_entries,
                                                     monkeypatch):
    """Pointers go as ``c_void_p`` and the stream last: a pointer passed as
    a 32-bit int would be cut."""
    argtypes = {}

    def recording_entry(source, symbol, types):
        argtypes[symbol] = types
        return None, lambda *a: 0

    monkeypatch.setattr(fa, "entry", recording_entry)
    q, k, v, do = inputs(BF16)
    out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True)
    fa.flash_attention_backward_fused(q, k, v, out, lse, do, causal=True)
    fa.flash_attention_backward_two_pass(q, k, v, out, lse, do, causal=True)
    fwd, bwd = argtypes["tf_flash_attention_fwd_tc"], \
        argtypes["tf_flash_attention_bwd_tc"]
    # after the scales: the window, the segment ids, dropout's seed pointer,
    # its threshold (uint32) and scale, and the stream
    tail = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_float, ctypes.c_void_p]
    assert fwd == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + tail
    assert bwd == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float] + tail
    for n, n_ptr in (("dkv", 8), ("dq", 7)):
        assert argtypes[f"tf_flash_attention_bwd_{n}_tc"] == (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_float] + tail)


@pytest.mark.parametrize("window,segmented", [(8, False), (None, True),
                                              (8, True)])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_a_window_or_segments_launch_the_masked_form(stub_entries, window,
                                                     segmented, dtype,
                                                     suffix):
    """With a window or segment ids every kernel calls its form's C entry
    with the window (0 for none) and the ids' pointer (None for none) after
    the scales, and counts under the form's name + MASK; without either the
    same entries get 0 and None and count under the unmasked names."""
    calls, _ = stub_entries
    q, k, v, do = inputs(dtype, Lq=72)    # segments need Lq == Lk
    seg = (torch.tensor(np.repeat(np.arange(9), 8)[None], dtype=torch.int64)
           if segmented else None)
    kw = dict(causal=True, window=window, segment_ids=seg)
    for masked_call in (True, False):
        calls.clear()
        mkw = kw if masked_call else dict(causal=True)
        (out, lse, _), fwd = counts_of(
            lambda: fa.flash_attention_forward(q, k, v, **mkw))
        _, fused = counts_of(lambda: fa.flash_attention_backward_fused(
            q, k, v, out, lse, do, **mkw))
        _, two = counts_of(lambda: fa.flash_attention_backward_two_pass(
            q, k, v, out, lse, do, **mkw))
        names = [fa._form_name(n, dtype, masked_call) for n in
                 (fa.KERNEL_FWD, fa.KERNEL_BWD, fa.KERNEL_DKV, fa.KERNEL_DQ)]
        assert {**fwd, **fused, **two} == dict.fromkeys(names, 1)
        assert all(n.endswith(suffix + fa.MASK) == masked_call
                   for n in names)
        assert [c[1] for c in calls] == [
            "tf_" + fa._form_name(n, dtype) for n in
            (fa.KERNEL_FWD, fa.KERNEL_BWD, fa.KERNEL_DKV, fa.KERNEL_DQ)]
        for _, _, a in calls:
            win, ptr = a[-6], a[-5]
            assert win == ((window or 0) if masked_call else 0)
            if masked_call and segmented:
                assert isinstance(ptr, int) and ptr != 0
            else:
                assert ptr is None
            assert a[-4:-1] == (None, 0, 1.0)    # no dropout


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,suffix", [(BF16, "_tc"), (FP32, "_x6")])
def test_dropout_launches_the_dropout_form(stub_entries, masked, dtype,
                                           suffix):
    """With dropout every kernel calls its form's C entry with the seed's
    device pointer (int32 [seed, batch offset, head offset]), the keep
    threshold and 1 / (1 - rate) before the stream, and counts under the
    form's name (+ MASK) + DROP; the seed is the caller's, padded with
    zeros, and never read back to the host."""
    calls, _ = stub_entries
    q, k, v, do = inputs(dtype, Lq=72)
    seen = []
    real = fa.dropout_seed_array

    def recording(seed, device):
        arr = real(seed, device)
        seen.append(arr)
        return arr

    fa_seed = torch.tensor([-9, 2], dtype=torch.int32)
    kw = dict(causal=True, dropout_rate=0.25, dropout_seed=fa_seed,
              window=8 if masked else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "dropout_seed_array", recording)
        (out, lse, _), fwd = counts_of(
            lambda: fa.flash_attention_forward(q, k, v, **kw))
        _, fused = counts_of(lambda: fa.flash_attention_backward_fused(
            q, k, v, out, lse, do, **kw))
        _, two = counts_of(lambda: fa.flash_attention_backward_two_pass(
            q, k, v, out, lse, do, **kw))
    names = [fa._form_name(n, dtype, masked, True) for n in
             (fa.KERNEL_FWD, fa.KERNEL_BWD, fa.KERNEL_DKV, fa.KERNEL_DQ)]
    assert {**fwd, **fused, **two} == dict.fromkeys(names, 1)
    assert all(n.endswith(suffix + fa.MASK * masked + fa.DROP)
               for n in names)
    assert [c[1] for c in calls] == [
        "tf_" + fa._form_name(n, dtype) for n in
        (fa.KERNEL_FWD, fa.KERNEL_BWD, fa.KERNEL_DKV, fa.KERNEL_DQ)]
    assert len(seen) == 3
    for arr in seen:
        assert arr.dtype == torch.int32 and arr.tolist() == [-9, 2, 0]
    for (_, _, a), arr in zip(calls, [seen[0], seen[1], seen[2], seen[2]]):
        assert a[-4:-1] == (arr.data_ptr(), fa.dropout_threshold(0.25),
                            pytest.approx(1 / 0.75))
        assert fa.dropout_threshold(0.25) == 2 ** 30
