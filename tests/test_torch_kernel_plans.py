"""The launch plans of the flash-decode and LayerNorm-backward kernels, and
the decode kernel's split of the positions over a thread-block cluster, on
the CPU.

``kernels/decode.py`` ``_plan`` (query rows a block, chunks of rows, blocks
a cluster) and ``kernels/layernorm.py`` ``_bwd_clusters`` (the backward's
persistent grid) are pure functions of the shape and the card's count of
streaming multiprocessors: which plan the serving shape, GQA with more rows
than a block holds, one sequence and large batches get on an H100's 132.
The wrappers run here with their C entries replaced by a recorder, to show
what a call hands the kernel.  ``split_decode`` below is the decode
kernel's arithmetic in plain PyTorch: each of the C blocks of a cluster
takes an equal share of the positions (empty where the length is below C or
a window leaves it nothing) and the shares' (max, sum, accumulator) are
merged in rank order; it is held against the JAX package's decode kernel
(Pallas interpret mode) at ``tests/test_torch_decode.py``'s tolerances
(1e-5 fp32, 3e-2 bf16 q), on inputs made from a numpy seed.  The CUDA
kernels themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.inference import KVCache as JaxKVCache
from tpu_flash.kernels.decode import flash_decode_attention as jax_decode
from tpu_flash_torch.kernels import decode, layernorm
from tpu_flash_torch.kernels.common import cdiv

torch.set_num_threads(1)

SMS = 132          # an H100 SXM
BF16, FP32, I8, F8 = (torch.bfloat16, torch.float32, torch.int8,
                      torch.float8_e4m3fn)


# --- flash decode ---------------------------------------------------------

def blocks(plan, B, Hkv):
    """The launch's blocks: a cluster for each (sequence, heads, chunk)."""
    return B * cdiv(Hkv, plan.heads) * plan.chunks * plan.cluster


@pytest.mark.parametrize("B,Hkv,G,d,dtype,rows,chunks,heads,cluster", [
    (8, 16, 1, 64, I8, 1, 1, 2, 2),      # the serving shape: 128 blocks
    (8, 16, 1, 64, BF16, 1, 1, 1, 1),    # 128 blocks, no split
    (8, 16, 1, 16, I8, 1, 1, 4, 4),      # 16-byte stripes: 4 heads a block
    (8, 4, 16, 64, BF16, 4, 4, 1, 1),    # Hq 16 over 4 KV heads, Lq 4
    (4, 2, 32, 64, BF16, 4, 8, 1, 2),    # Lq 8, 4 query heads a KV head
    (4, 2, 32, 64, F8, 2, 16, 2, 2),
    (2, 1, 128, 32, FP32, 8, 16, 1, 4),  # MQA, Lq 8: 128 blocks
    (1, 16, 1, 64, I8, 1, 1, 2, 8),      # one sequence: the largest cluster
    (64, 16, 1, 64, I8, 1, 1, 2, 1),     # enough blocks without a split
])
def test_decode_plan(B, Hkv, G, d, dtype, rows, chunks, heads, cluster):
    plan = decode._plan(B, Hkv, G, d, dtype, SMS)
    assert plan == decode.Plan(rows, chunks, heads, cluster)


@pytest.mark.parametrize("dtype", [FP32, BF16, I8, F8])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_decode_plan_rows_and_cluster_bounds(dtype, sms):
    """Rows a power of two within the kernel's registers (32 / values a
    16-byte load: the C entry refuses more), chunks that cover the group,
    heads whose lanes fit in a warp, a cluster of at most 8 that gives FILL
    blocks an SM where 8 can."""
    for B, Hkv, G, d in itertools.product((1, 3, 8, 64), (1, 4, 16),
                                          (1, 2, 3, 8, 16, 64),
                                          (16, 32, 64, 128)):
        plan = decode._plan(B, Hkv, G, d, dtype, sms)
        values = decode._VALUES[dtype]
        fill = decode.FILL * sms
        assert plan.rows & (plan.rows - 1) == 0
        assert plan.rows <= 32 // values
        assert plan.chunks == cdiv(G, plan.rows)
        assert 1 <= plan.heads <= decode.MAX_HEADS
        assert plan.heads * (d // values) <= 32
        assert 1 <= plan.cluster <= decode.MAX_CLUSTER
        assert (plan.cluster == decode.MAX_CLUSTER
                or blocks(plan, B, Hkv) >= fill)
        assert plan.cluster == 1 or blocks(plan, B, Hkv) < 2 * fill


class Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, fn, dev, *args):
        self.calls.append(args)
        return 0


def test_a_decode_call_hands_the_kernel_its_plan(monkeypatch):
    """The serving shape over an int8 cache: the C entry gets the plan's
    rows and cluster after the window, and the call counts one launch."""
    rec = Recorder()
    monkeypatch.setattr(decode, "entry", lambda *a: (None, None))
    monkeypatch.setattr(decode, "call_on_stream", rec)
    monkeypatch.setattr(decode, "sm_count", lambda dev: SMS)
    B, H, S, d = 8, 16, 64, 64
    q = torch.zeros(B, H, 1, d, dtype=BF16)
    k = torch.zeros(B, S, H * d, dtype=I8)
    scales = torch.ones(B, H, S)
    lengths = torch.full((B,), 10, dtype=torch.int32)
    before = decode.launch_counts[decode.KERNEL]
    decode._launch(q, k, k, lengths, scales, scales, H, 0.125, 5)
    (args,) = rec.calls
    plan = decode._plan(B, H, 1, d, I8, SMS)
    assert args[7:] == (B, H, H, 1, S, d, 1, 2, 0.125, 5, plan.rows,
                        plan.cluster)
    assert decode.launch_counts[decode.KERNEL] == before + 1


def split_decode(q, k, v, lengths, k_scale, v_scale, cluster, window):
    """The decode kernel's function as it computes it: the positions
    [start, min(length, S)) cut into ``cluster`` equal shares, each share's
    running max, sum of p (before the V scale) and accumulator of P.V (p
    times the V scale rounded to q's dtype), merged in share order; q *
    scale rounded to q's dtype; a row that sees no position gives 0."""
    B, Hq, Lq, d = q.shape
    S, H = k.shape[1], k.shape[2] // d
    g = Hq // H
    qs = (q.float() / math.sqrt(d)).to(q.dtype).float()
    qs = qs.reshape(B, H, g, Lq, d)
    kk = k.float().reshape(B, S, H, d).permute(0, 2, 1, 3)
    vv = v.float().reshape(B, S, H, d).permute(0, 2, 1, 3)
    ks = torch.ones(B, H, S) if k_scale is None else k_scale
    vs = torch.ones(B, H, S) if v_scale is None else v_scale
    out = torch.zeros(B, H, g, Lq, d)
    for b in range(B):
        length = int(lengths[b])
        end = min(length, S)
        limit = length - Lq + 1 + torch.arange(Lq)           # [Lq]
        first = limit - window if window else torch.zeros_like(limit)
        start = max(0, int(first[0])) if window else 0
        share = cdiv(max(0, end - start), cluster)
        ms, ls, accs = [], [], []
        for r in range(cluster):
            s0 = min(end, start + r * share)
            pos = torch.arange(s0, min(end, s0 + share))
            s = torch.einsum("hgid,hnd->hgin", qs[b], kk[b][:, pos])
            s = s * ks[b][:, None, None, pos]
            valid = (pos < limit[:, None]) & (pos >= first[:, None])
            m = (torch.where(valid, s, -math.inf).amax(-1) if len(pos)
                 else torch.full(s.shape[:-1], -math.inf))
            p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            w = (p * vs[b][:, None, None, pos]).to(q.dtype).float()
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("hgin,hnd->hgid", w, vv[b][:, pos]))
        mx = torch.stack(ms).amax(0)
        lsum, acc = torch.zeros_like(mx), torch.zeros(H, g, Lq, d)
        for m, l_, a in zip(ms, ls, accs):
            f = torch.where(m > -math.inf, torch.exp(m - mx), 0.0)
            lsum = lsum + l_ * f
            acc = acc + a * f[..., None]
        out[b] = torch.where(lsum[..., None] > 0, acc / lsum[..., None], 0.0)
    return out.reshape(B, Hq, Lq, d).to(q.dtype)


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype,quant", [(jnp.float32, "none"),
                                         (jnp.bfloat16, "int8")])
@pytest.mark.parametrize("window", [None, 3])
def test_the_split_over_a_cluster_matches_jax(dtype, quant, window):
    """Clusters of 4 over lengths 0, 1, 3 (below C), 4, 7 and 60, two tokens
    of query each with its own causal limit, two query heads a KV head; a
    window of 3 leaves all but one or two shares empty.  A length past S
    (70: an idle engine slot) reads the S positions there are; the TPU
    kernel's tiles there fall past the cache, so that sequence is held
    against the port's plain version only."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, Lq, S, d, C = 7, 4, 2, 2, 64, 16, 4
    q = jnp.asarray(rng.standard_normal((B, Hq, Lq, d)) * 0.5, dtype)
    kv = [jnp.asarray(rng.standard_normal((B, Hkv, S, d)) * 0.5, dtype)
          for _ in range(2)]
    cache = JaxKVCache.create(B, Hkv, S, d, quant=quant, compute_dtype=dtype)
    cache = jax.jit(lambda c, k, v: c.append(k, v))(cache, *kv)
    lengths = np.array([0, 1, C - 1, C, 7, 60, 70], np.int32)
    want = jax_decode(q, cache.k, cache.v, jnp.asarray(lengths),
                      cache.k_scale, cache.v_scale, window=window)
    scales = ((None, None) if cache.k_scale is None else
              (to_torch(cache.k_scale), to_torch(cache.v_scale)))
    args = (to_torch(q), to_torch(cache.k), to_torch(cache.v),
            torch.from_numpy(lengths))
    got = split_decode(*args, *scales, C, window).float()
    plain = decode.flash_decode_attention_plain(*args, *scales,
                                                window=window).float()
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    want = to_torch(want).float()
    torch.testing.assert_close(got[:-1], want[:-1], atol=tol, rtol=tol)
    torch.testing.assert_close(plain[:-1], want[:-1], atol=tol, rtol=tol)
    torch.testing.assert_close(got, plain, atol=tol, rtol=tol)
    assert not got[0].any()                      # length 0: every row 0


# --- LayerNorm backward ---------------------------------------------------

@pytest.mark.parametrize("R,H,clusters", [
    (8192, 256, 66),     # the reference MT shape: 4 blocks an SM
    (8192, 512, 33),     # the production width (mode (e)): 2 an SM
    (8192, 1024, 17),    # held at the widest: 1 an SM
    (8192, 640, 17),
    (8192, 2000, 66),    # the looped form: 4 an SM
    (8192, 70, 66),
    (1000, 256, 16),     # a row a warp: 125 blocks
    (37, 200, 1),
    (0, 256, 1),         # no rows: one cluster writes dgamma = dbeta = 0
])
def test_layernorm_backward_grid(R, H, clusters):
    assert layernorm._bwd_clusters(R, H, SMS) == clusters


def test_layernorm_backward_call_hands_the_kernel_its_grid(monkeypatch):
    """One launch a call, with the plan's clusters and the device's cached
    workspace (8 counters and each cluster's [2H] sums), grown only when a
    call needs more; dgamma and dbeta are the kernel's outputs, in gamma's
    dtype, with nothing summed after it."""
    rec = Recorder()
    monkeypatch.setattr(layernorm, "entry", lambda *a: (None, None))
    monkeypatch.setattr(layernorm, "call_on_stream", rec)
    monkeypatch.setattr(layernorm, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(layernorm, "_workspaces", {})
    before = layernorm.launch_counts[layernorm.KERNEL_BWD]
    for R, H, dtype in ((8192, 256, FP32), (64, 256, BF16),
                         (8192, 1024, BF16)):
        x = torch.zeros(R, H, dtype=dtype)
        stats = torch.zeros(R)
        _, dgamma, dbeta = layernorm._launch_backward(
            x, x, torch.ones(H, dtype=dtype), stats, stats)
        assert dgamma.dtype == dbeta.dtype == dtype
        assert dgamma.shape == dbeta.shape == (H,)
    first, second, third = rec.calls
    ws = layernorm._workspaces[torch.device("cpu")]
    assert first[8] == second[8] != third[8] == ws.data_ptr()
    assert ws.numel() == 8 + 17 * 2 * 1024
    assert [c[9:12] for c in rec.calls] == [(8192, 256, 66), (64, 256, 1),
                                            (8192, 1024, 17)]
    assert [c[12:] for c in rec.calls] == [(0, 0, 0), (1, 1, 1), (1, 1, 1)]
    assert layernorm.launch_counts[layernorm.KERNEL_BWD] == before + 3


# --- the LayerNorm forward -------------------------------------------------

@pytest.mark.parametrize("dtype,H,plan", [
    # a row held in 16-byte vectors; 8192 rows take 2 blocks an SM, 264,
    # each warp two passes (of two rows at once up to 32 bytes a lane)
    (BF16, 32, (8, 1, 264)),
    (BF16, 100, (4, 1, 264)),     # H % 8 != 0: 8-byte bf16 vectors
    (BF16, 256, (8, 1, 264)),     # the reference MT width
    (BF16, 512, (8, 2, 264)),     # the production width
    (BF16, 1024, (8, 4, 264)),    # one row a warp at once
    (BF16, 4096, (0, 0, 264)),    # past the held rows: the looped form
    (FP32, 32, (4, 1, 264)),
    (FP32, 100, (4, 1, 264)),
    (FP32, 256, (4, 2, 264)),
    (FP32, 512, (4, 4, 264)),
    (FP32, 1024, (4, 8, 264)),
    (FP32, 4096, (0, 0, 264)),
    (FP32, 70, (0, 0, 264)),      # H % 4 != 0: the looped form
])
def test_layernorm_forward_plan(dtype, H, plan):
    assert layernorm._fwd_plan(8192, H, dtype, SMS) == layernorm.FwdPlan(
        *plan)


def test_layernorm_forward_plan_bounds():
    """Held rows fit the kernel's vectors (32 V NV >= H, NV a power of two,
    no wider than needed), at most 1024 values; the grid is the plan's
    blocks an SM, fewer where the rows need fewer, never empty."""
    for dtype, H, R in itertools.product((BF16, FP32), range(4, 1100, 4),
                                         (0, 1, 37, 8192, 100_000)):
        p = layernorm._fwd_plan(R, H, dtype, SMS)
        assert 1 <= p.blocks <= layernorm.LN_FWD_BLOCKS_PER_SM * SMS
        if H > layernorm.LN_FWD_HELD_MAX:
            assert p == (0, 0, p.blocks)
            continue
        item = 2 if dtype == BF16 else 4
        assert H % p.V == 0 and p.NV & (p.NV - 1) == 0
        assert 32 * p.V * p.NV >= H and (p.NV == 1 or H > 16 * p.V * p.NV)
        rows = 2 if p.V * p.NV * item <= 32 else 1   # held_rows
        assert p.blocks == max(1, min(cdiv(R, 8 * rows),
                                      layernorm.LN_FWD_BLOCKS_PER_SM * SMS))


def test_layernorm_forward_call_hands_the_kernel_its_plan(monkeypatch):
    """The C entry gets R, H, the dtypes and then the plan (V, NV,
    blocks); one launch a call."""
    rec = Recorder()
    monkeypatch.setattr(layernorm, "entry", lambda *a: (None, None))
    monkeypatch.setattr(layernorm, "call_on_stream", rec)
    monkeypatch.setattr(layernorm, "sm_count", lambda dev: SMS)
    before = layernorm.launch_counts[layernorm.KERNEL_FWD]
    for R, H, dtype, gdt in ((8192, 256, BF16, BF16), (8192, 512, FP32, FP32),
                             (37, 70, BF16, FP32)):
        x = torch.zeros(R, H, dtype=dtype)
        g = torch.ones(H, dtype=gdt)
        y, mean, var = layernorm._launch_forward(x, g, torch.zeros_like(g))
        assert y.dtype == dtype and mean.shape == var.shape == (R,)
    assert [c[6:] for c in rec.calls] == [
        (8192, 256, 1, 1, 8, 1, 264), (8192, 512, 0, 0, 4, 4, 264),
        (37, 70, 1, 0, 0, 0, 5)]
    assert layernorm.launch_counts[layernorm.KERNEL_FWD] == before + 3
