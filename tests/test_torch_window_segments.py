"""Sliding-window and packed-segment attention in the port against the JAX
package, on the CPU.

The flash kernels' plain versions (forward, fused backward and the two
passes' halves) under ``window`` and ``segment_ids`` against the JAX
package's ``flash_attention_forward`` / ``flash_attention_backward`` (Pallas
in interpret mode, as its own tests run it) at the reference tolerances,
forward 1e-3 and backward 1e-2 in fp32; the validation errors against the
JAX op's; ``DecoderLM`` on the flash and naive routes with a window and
with packed rows against the JAX model with the same parameters
(``load_jax_params``) at 1e-5; packed rows giving each example's unpacked
logits; the port's ``collate_packed`` and ``synthetic_translation_dataset``
against the JAX package's, array for array, with one stand-in word
tokenizer; and the backward's form under a window against the JAX
selector.  A rehearsal of the fused backward's ordered dQ adds under a
window walks every key tile's query chunks and wait targets as the kernel
computes them (``query_tiles`` and ``dq_turn`` of
csrc/flash_attention_bwd.cuh) and shows every wait is met and the adds to
each chunk come in key-tile order.  Inputs come from a numpy seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.data import mt as jmt
from tpu_flash.kernels import flash_attention as jfa
from tpu_flash.ops import flash_attention as jax_op
from tpu_flash_torch import nn as tnn
from tpu_flash_torch import ops as tops
from tpu_flash_torch.data import mt as tmt
from tpu_flash_torch.kernels import backward_form
from tpu_flash_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

FW_TOL = dict(atol=1e-3, rtol=1e-3)
BW_TOL = dict(atol=1e-2, rtol=1e-3)
F32 = dict(atol=1e-5, rtol=1e-5)


def packed_ids(rng, B, L):
    """Segment ids [B, L] of a packed batch: runs of 1 to 24 positions
    (length-1 runs among them), and a pad-tail segment in every row but the
    last."""
    rows = []
    for b in range(B):
        ids, sid = [], 0
        tail = 0 if b == B - 1 else int(rng.integers(1, L // 4))
        while len(ids) < L - tail:
            n = 1 if rng.random() < 0.25 else int(rng.integers(2, 25))
            ids += [sid] * min(n, L - tail - len(ids))
            sid += 1
        rows.append(ids + [sid] * tail)
    return np.asarray(rows, np.int32)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# B, H, Hkv, Lq, Lk, d, window, segmented
CASES = [
    (1, 2, 1, 128, 128, 32, 16, False),
    (2, 2, 1, 200, 200, 64, 64, False),
    (1, 2, 2, 96, 96, 32, 1, False),
    (1, 2, 2, 130, 130, 32, 500, False),     # a window beyond L: causal
    (1, 2, 1, 64, 192, 64, 80, False),       # Lq < Lk
    (2, 2, 1, 160, 160, 32, None, True),
    (1, 2, 1, 200, 200, 64, 50, True),
]


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,window,segmented", CASES)
def test_forward_and_backward_match_jax(rng, B, H, Hkv, Lq, Lk, d, window,
                                        segmented):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, Lq, d), (B, Hkv, Lk, d), (B, Hkv, Lk, d),
               (B, H, Lq, d))]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    seg = packed_ids(rng, B, Lq) if segmented else None
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    jout, jlse, _ = jfa.flash_attention_forward(
        jq, jk, jv, causal=True, window=window, segment_ids=jseg)
    out, lse, _ = tfa.flash_attention_forward(
        q, k, v, causal=True, window=window, segment_ids=tseg)
    np.testing.assert_allclose(np32(out), np32(jout), **FW_TOL)
    np.testing.assert_allclose(np32(lse), np32(jlse), **FW_TOL)
    want = jfa.flash_attention_backward(jq, jk, jv, jout, jlse, jdo,
                                        causal=True, window=window,
                                        segment_ids=jseg)
    kw = dict(causal=True, window=window, segment_ids=tseg)
    fused = tfa.flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    two = tfa.flash_attention_backward_two_pass(q, k, v, out, lse, do, **kw)
    for got in (fused, two):
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), **BW_TOL)


def test_the_op_trains_through_window_and_segments(rng):
    """The autograd Function with a window and segments against autograd
    through naive attention under the same masks."""
    B, H, L, d = 2, 2, 48, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, d))
                                    .astype(np.float32)) for _ in range(4))
    seg = torch.from_numpy(packed_ids(rng, B, L))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=True, window=9,
                               segment_ids=seg)
    grads = torch.autograd.grad((out * do).sum(), leaves)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = (tops.window_mask(L, L, 9)
            + tops.apply_segment_mask(torch.zeros(B, 1, L, L), seg))
    ref = tops.naive_attention(*ref_leaves, causal=True, mask=mask)
    ref_grads = torch.autograd.grad((ref * do).sum(), ref_leaves)
    torch.testing.assert_close(out, ref, **F32)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kwargs,Lk,seg_shape", [
    (dict(window=4, causal=False), 32, None),   # window without causal
    (dict(window=0, causal=True), 32, None),    # window 0
    (dict(causal=True), 32, (1, 31)),           # a wrong segment shape
    (dict(causal=True), 48, (1, 32)),           # Lq != Lk
])
def test_validation_errors_match_jax(kwargs, Lk, seg_shape):
    q = np.zeros((1, 2, 32, 16), np.float32)
    kv = np.zeros((1, 2, Lk, 16), np.float32)
    seg = None if seg_shape is None else np.zeros(seg_shape, np.int32)
    with pytest.raises(ValueError) as jax_err:
        jax_op(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
               segment_ids=None if seg is None else jnp.asarray(seg),
               **kwargs)
    with pytest.raises(ValueError) as port_err:
        tops.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                             torch.from_numpy(kv),
                             segment_ids=(None if seg is None
                                          else torch.from_numpy(seg)),
                             **kwargs)
    assert str(port_err.value) == str(jax_err.value)


# --- the model ---------------------------------------------------------------

CFG = dict(n_vocab=96, n_embd=32, n_head=2, n_positions=64, n_layer=2,
           ff_middle_dim=64, p_dropout=0.0)


def make_pair(**over):
    """The JAX model (a jitted forward) with params from its own init, and
    the port with the same params."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, **over))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, **over), device="cpu")
    tnn.load_jax_params(tm, params)
    return jax.jit(lambda p, ids, **kw: jm(p, ids, **kw)), params, tm


@pytest.mark.parametrize("kind", ["flash", "naive"])
@pytest.mark.parametrize("window,packed", [(5, False), (None, True),
                                           (7, True)])
def test_model_matches_jax(rng, kind, window, packed):
    fwd, params, tm = make_pair(attention_kind=kind, window=window)
    B, L = 2, 40
    ids = rng.integers(0, CFG["n_vocab"], (B, L))
    kw = {}
    if packed:
        seg = packed_ids(rng, B, L)
        pos = np.zeros_like(seg)
        for b in range(B):
            for s in np.unique(seg[b]):
                where = np.flatnonzero(seg[b] == s)
                pos[b, where] = np.arange(len(where))
        kw = dict(segment_ids=seg, positions=pos)
    want = fwd(params, jnp.asarray(ids, jnp.int32),
               **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tm(torch.from_numpy(ids),
             **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("kind", ["flash", "naive"])
def test_model_packed_equals_unpacked(rng, kind):
    """Two examples packed into one row (segment ids and per-example
    positions) give the logits of the two separate forwards, as in the JAX
    package's test_model_packed_equals_unpacked."""
    _, _, tm = make_pair(attention_kind=kind)
    a = torch.from_numpy(rng.integers(0, CFG["n_vocab"], (1, 10)))
    b = torch.from_numpy(rng.integers(0, CFG["n_vocab"], (1, 14)))
    seg = torch.tensor([[0] * 10 + [1] * 14])
    pos = torch.tensor([list(range(10)) + list(range(14))])
    packed = tm(torch.cat([a, b], dim=1), segment_ids=seg, positions=pos)
    torch.testing.assert_close(packed[:, :10], tm(a), **F32)
    torch.testing.assert_close(packed[:, 10:], tm(b), **F32)


# --- the packed collate -------------------------------------------------------

def test_synthetic_dataset_matches_jax():
    kw = dict(n_train=60, n_validation=7, n_test=5, n_words=120, seed=3)
    assert (tmt.synthetic_translation_dataset(**kw)
            == jmt.synthetic_translation_dataset(**kw))


@pytest.mark.parametrize("row_length,fixed_rows,max_rows", [
    (48, None, None), (64, 3, None), (40, None, 2), (16, 12, None)])
def test_collate_packed_matches_jax(row_length, fixed_rows, max_rows):
    data = tmt.synthetic_translation_dataset(n_train=40, n_validation=1,
                                             n_test=1, n_words=60)
    tok = tmt.WordTokenizer(data["train"])
    drops = {"jax": [], "port": []}
    want = jmt.collate_packed(data["train"], "de", "en", tok, row_length,
                              max_rows=max_rows, fixed_rows=fixed_rows,
                              drop_counter=drops["jax"])
    got = tmt.collate_packed(data["train"], "de", "en", tok, row_length,
                             max_rows=max_rows, fixed_rows=fixed_rows,
                             drop_counter=drops["port"])
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert drops["port"] == drops["jax"]


# --- the backward's form and the fused backward's ordered dQ adds -------------

@pytest.mark.parametrize("L,itemsize,window", [
    (16384, 2, 2048), (2048, 2, 256), (2048, 4, 256), (8192, 4, 2048),
    (16384, 4, 2048), (4096, 2, 64), (32768, 2, 4096)])
def test_backward_form_under_a_window_matches_jax(L, itemsize, window):
    for d in (64, 128):
        block_k = min(jfa.DEFAULT_BLOCK_K_BWD, -(-L // 8) * 8)
        if itemsize >= 4:
            block_k = min(block_k, 512)
        want = not jfa.select_bwd_fused_config(
            L, L, d, block_q=None, block_k=block_k, causal=True, q_offset=0,
            itemsize=itemsize, window=window)[0]
        assert backward_form.two_pass(L, L, d, itemsize, True, 0,
                                      window) == want


KEY_TILE = 64   # kTcBlock: the keys of a block of the KV-outer kernels
NO_BAND = 1 << 30


def chunk_walk(Lq, Lk, q_offset, window, chunk):
    """For each key tile, the first rows of the query chunks its block
    walks, in walk order (the last down), and its wait target at each: the
    fused kernels' query_tiles, tile_i0 and dq_turn."""
    win = NO_BAND if window is None else window
    walks = []
    for tile in range(-(-Lk // KEY_TILE)):
        k0 = tile * KEY_TILE
        first = max(0, k0 - q_offset)
        q_start = first - first % chunk
        last = min(Lq - 1, k0 + KEY_TILE - 1 + win - 1 - q_offset)
        nt = (last - q_start) // chunk + 1 if q_start <= last else 0
        steps = []
        for it in range(nt):
            i0 = q_start + (nt - 1 - it) * chunk
            x = i0 + q_offset - win - (KEY_TILE - 2)
            steps.append((i0, tile - (math.ceil(x / KEY_TILE) if x > 0
                                      else 0)))
        walks.append(steps)
    return walks


@pytest.mark.parametrize("chunk", [64, 32])
@pytest.mark.parametrize("Lq,Lk,q_offset", [
    (2048, 2048, 0), (700, 700, 0), (130, 257, 127), (300, 700, 100),
    (257, 130, -127), (500, 400, -30)])
@pytest.mark.parametrize("window", [None, 1, 63, 64, 100, 256, 2048])
def test_fused_backward_ticket_walk_under_a_window(chunk, Lq, Lk, q_offset,
                                                   window):
    """Blocks start in key-tile order and at most `resident` run at once
    (a block that has started runs to its end); each waits at a chunk until
    the chunk's counter reaches its target, adds, and sets the counter to
    target + 1.  Every block ends (no wait is unmet, whatever the
    residency), each chunk's adds come in key-tile order from the first
    key tile that reaches it, and each chunk counts the key tiles that
    reach it."""
    walks = chunk_walk(Lq, Lk, q_offset, window, chunk)
    visitors = {}
    for tile, steps in enumerate(walks):
        for i0, turn in steps:
            visitors.setdefault(i0, []).append((tile, turn))
    for i0, tiles in visitors.items():
        first = tiles[0][0]
        # the key tiles that reach a chunk are a run, and each waits for
        # the ones of the run below it
        assert [t for t, _ in tiles] == list(range(first, first + len(tiles)))
        assert [turn for _, turn in tiles] == list(range(len(tiles)))
    for resident in (1, 3, len(walks)):
        counters = dict.fromkeys(visitors, 0)
        order = {i0: [] for i0 in visitors}
        pos = [0] * len(walks)
        started, done = 0, set()
        while len(done) < len(walks):
            before = started
            while started < len(walks) and started - len(done) < resident:
                started += 1
            moved = started > before
            for tile in range(started):
                if tile in done:
                    continue
                while pos[tile] < len(walks[tile]):
                    i0, turn = walks[tile][pos[tile]]
                    if counters[i0] != turn:
                        break
                    order[i0].append(tile)
                    counters[i0] = turn + 1
                    pos[tile] += 1
                    moved = True
                if pos[tile] == len(walks[tile]):
                    done.add(tile)
                    moved = True
            assert moved, f"deadlock at {resident} resident blocks"
        for i0, tiles in visitors.items():
            assert order[i0] == [t for t, _ in tiles]
            assert counters[i0] == len(tiles)
