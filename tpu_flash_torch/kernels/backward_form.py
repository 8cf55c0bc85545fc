"""Which form the flash-attention backward takes: the fused single pass or
the two passes (dK/dV, then dQ).

A copy of the decision ``tpu_flash/kernels/flash_attention.py`` makes in
``flash_attention_backward`` (:1783-1830): the entry's clamps on the tiles,
then ``select_bwd_fused_config``'s ``will_fuse`` verdict (:1472-1649) with
what it calls (``select_bwd_dkv_config`` :1652, ``_tile_schedule`` :132,
``_width_class`` :223, ``_subtile_width`` :235, ``_packed_kv_schedule`` :260,
``_fold_l`` :403).  It is integer and numpy code, kept here as the port's own
copy (the port imports nothing of the JAX package).

The rule is the TPU's: its constants model the fused kernel's footprint in
a TensorCore's VMEM and its cost per grid step, calibrated on a TPU v5e.
The port keeps it unchanged so that both packages run the same form on the
same shapes (bf16: two passes from L = 16384; fp32: from 8192 at d = 64,
from 4096 at d = 128, causal, Lq = Lk).  It is not tuned for the H100:
``chip_smoke.py`` times both forms there (PERF.md).  The ``wq`` score
layout is not ported, and with ``segment_ids`` the JAX rule takes the
``qw`` layout, so its ``wq_cols`` term is 0 here and left out, as is the
explicit ``q_pack`` of its sweeps.  Dropout does not enter the rule.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu_flash_torch.kernels.common import round_up

LANES = 128        # the TPU's lane width, which the footprint model counts in
DEFAULT_BLOCK_Q_BWD = 512
DEFAULT_BLOCK_K_BWD = 2048

_FIRST, _LAST, _MASK, _LIVE = 1, 2, 4, 8

# Scoped-VMEM caps of the fused single pass (bytes), as the JAX package
# calibrated them on the TPU.
_FUSED_VMEM_CAP_BF16 = int(12.5 * 1024 * 1024)
_FUSED_VMEM_CAP_FP32 = int(9.5 * 1024 * 1024)


def _width_class(live_cols: int, block_k: int) -> int:
    gran = max(LANES, block_k // 4)
    return min(block_k, round_up(live_cols, gran))


def _fold_l(d: int) -> bool:
    return round_up(d + 1, LANES) == round_up(d, LANES)


def _tile_schedule(num_q, num_kv, *, block_q, block_k, causal, q_offset,
                   kv_len, kv_outer=False, window=None):
    """The (q tile, kv tile) visits of the unpacked schedule:
    ``(imap, jmap, flags, wmap, widths)``."""
    def live(i, j):
        if j * block_k >= kv_len:
            return False
        if not causal:
            return True
        if j * block_k > q_offset + (i + 1) * block_q - 1:
            return False
        if window is not None and \
                (j + 1) * block_k - 1 <= q_offset + i * block_q - window:
            return False
        return True

    def width(i, j):
        if not live(i, j):
            return 0
        if window is not None and \
                j * block_k < q_offset + i * block_q - window + 1:
            return block_k
        hi = min(kv_len, (j + 1) * block_k)
        if causal:
            hi = min(hi, q_offset + (i + 1) * block_q)
        return _width_class(hi - j * block_k, block_k)

    def needs_mask(i, j):
        need = (j + 1) * block_k > kv_len
        if causal:
            need = need or ((j + 1) * block_k - 1 > q_offset + i * block_q)
        return need

    widths: list[int] = []
    width_ids: dict[int, int] = {}

    def wid(i, j, forced):
        if forced:
            return -1
        w = width(i, j)
        if w not in width_ids:
            width_ids[w] = len(widths)
            widths.append(w)
        return width_ids[w]

    entries = []
    outer, inner = (num_kv, num_q) if kv_outer else (num_q, num_kv)
    for a in range(outer):
        pairs = [(i, a) if kv_outer else (a, i) for i in range(inner)]
        live_pairs = [ij for ij in pairs if live(*ij)]
        forced = not live_pairs
        if forced:
            live_pairs = [(num_q - 1, a) if kv_outer else (a, 0)]
        for idx, (i, j) in enumerate(live_pairs):
            f = (_FIRST if idx == 0 else 0) \
                | (_LAST if idx == len(live_pairs) - 1 else 0) \
                | (0 if forced else _LIVE) \
                | (_MASK if (not forced and needs_mask(i, j)) else 0)
            entries.append((i, j, f, wid(i, j, forced)))
    arr = np.asarray(entries, np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], tuple(widths)


def _subtile_width(i, j, *, block_q, block_k, causal, q_offset, kv_len,
                   window=None):
    if j * block_k >= kv_len:
        return 0
    first_row = q_offset + i * block_q
    last_row = q_offset + (i + 1) * block_q - 1
    if causal and j * block_k > last_row:
        return 0
    if window is not None and (j + 1) * block_k - 1 <= first_row - window:
        return 0
    if window is not None and j * block_k < first_row - window + 1:
        return block_k
    hi = min(kv_len, (j + 1) * block_k)
    if causal:
        hi = min(hi, last_row + 1)
    return _width_class(hi - j * block_k, block_k)


def _packed_kv_schedule(num_groups, num_kv, *, block_q, block_k, causal,
                        q_offset, kv_len, q_pack, window=None):
    """KV tiles outer, and in each the groups of ``q_pack`` Q sub-tiles with
    a live pair: ``(gmap, jmap, flags, pat, patterns)``."""
    entries = []
    patterns: list[tuple[int, ...]] = []
    pattern_ids: dict[tuple[int, ...], int] = {}

    def pat_id(vec):
        if vec not in pattern_ids:
            pattern_ids[vec] = len(patterns)
            patterns.append(vec)
        return pattern_ids[vec]

    def width(g, h, j):
        return _subtile_width(
            g * q_pack + h, j, block_q=block_q, block_k=block_k,
            causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)

    for j in range(num_kv):
        gs = [g for g in range(num_groups)
              if any(width(g, h, j) for h in range(q_pack))]
        forced = not gs
        if forced:
            gs = [num_groups - 1]
        for idx, g in enumerate(gs):
            f = (_FIRST if idx == 0 else 0) \
                | (_LAST if idx == len(gs) - 1 else 0) \
                | (0 if forced else _LIVE)
            vec = tuple(0 if forced else width(g, h, j)
                        for h in range(q_pack))
            entries.append((g, j, f, pat_id(vec)))
    arr = np.asarray(entries, np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], tuple(patterns)


def select_bwd_fused_config(Lq, Lk, d, *, block_q, block_k, causal,
                            q_offset, itemsize, window=None):
    """``(will_fuse, block_q, q_pack, block_k, pLq, dq_hbm)``, the JAX
    package's joint tile choice for the fused backward: the candidate with
    the fewest grid steps under the footprint cap, kept only where the cost
    model (dots at 92 TFLOP/s and 1.3 us a grid step, TPU figures) says it
    beats the two passes."""
    dwf = d + 1 if _fold_l(d) else d

    def footprint(bq, bk, pack, pLq_, hbm):
        score_tiles = 2 if pack == 1 else 4
        if hbm and pack == 1:
            score_tiles = 3
        group_rows = min(pLq_, bq * pack)
        dq_out = (group_rows * round_up(d, 128) * itemsize
                  + group_rows * d * 4
                  + pLq_ * dwf * 4 if hbm
                  else 3 * pLq_ * d * itemsize)
        return (score_tiles * bq * bk * 4
                + 2 * bk * dwf * 4
                + pLq_ * dwf * 4
                + dq_out
                + 4 * bk * d * itemsize
                + 4 * pack * bq * d * itemsize)

    cap = _FUSED_VMEM_CAP_FP32 if itemsize >= 4 else _FUSED_VMEM_CAP_BF16
    bq_candidates = ([block_q] if block_q is not None
                     else [min(b, round_up(Lq, 8)) for b in (512, 256)])
    best = None
    for bq in dict.fromkeys(bq_candidates):
        num_q_tiles = round_up(Lq, bq) // bq
        if itemsize >= 4 and d >= 128:
            pack_candidates = [1]
        else:
            pack_candidates = [p for p in (8, 4, 2, 1) if p <= num_q_tiles]
        for pack in pack_candidates:
            pLq_p = round_up(Lq, bq * pack)
            hbm_ok = itemsize == 2 and pLq_p <= 8192
            for hbm in ((False, True) if hbm_ok else (False,)):
                cap_m = int(14.0 * 1024 * 1024) if hbm else cap
                bk_p = block_k
                while bk_p > 512 and \
                        footprint(bq, bk_p, pack, pLq_p, hbm) > cap_m:
                    bk_p //= 2
                if footprint(bq, bk_p, pack, pLq_p, hbm) > cap_m:
                    continue
                gmap_p, *_ = _packed_kv_schedule(
                    pLq_p // (bq * pack), round_up(Lk, bk_p) // bk_p,
                    block_q=bq, block_k=bk_p, causal=causal,
                    q_offset=q_offset, kv_len=Lk, q_pack=pack,
                    window=window)
                key = (len(gmap_p), -bk_p, bq, hbm)
                if best is None or key < best[0]:
                    best = (key, bq, pack, bk_p, pLq_p, hbm)
    if best is None:
        bq = min(block_q or DEFAULT_BLOCK_Q_BWD, round_up(Lq, 8))
        return False, bq, 1, block_k, round_up(Lq, bq), False
    _, bq, pack, bk, pLq, hbm = best

    bq2 = min(block_q or DEFAULT_BLOCK_Q_BWD, round_up(Lq, 8))
    pack2, bk2, pLq2 = select_bwd_dkv_config(
        Lq, Lk, d, block_q=bq2, block_k=block_k, causal=causal,
        q_offset=q_offset, itemsize=itemsize, window=window)
    s_dkv, *_ = _packed_kv_schedule(
        pLq2 // (bq2 * pack2), round_up(Lk, bk2) // bk2, block_q=bq2,
        block_k=bk2, causal=causal, q_offset=q_offset, kv_len=Lk,
        q_pack=pack2, window=window)
    s_dq, *_ = _tile_schedule(
        round_up(Lq, bq2) // bq2, round_up(Lk, block_k) // block_k,
        block_q=bq2, block_k=block_k, causal=causal, q_offset=q_offset,
        kv_len=Lk, kv_outer=False, window=window)
    gmap_f, _, fl_f, pat_f, patterns_f = _packed_kv_schedule(
        pLq // (bq * pack), round_up(Lk, bk) // bk, block_q=bq,
        block_k=bk, causal=causal, q_offset=q_offset, kv_len=Lk,
        q_pack=pack, window=window)
    macs = sum(bq * w * d
               for f, pv in zip(fl_f, pat_f) if int(f) & _LIVE
               for w in patterns_f[int(pv)]) * 2.0
    c_step, rate = 1.3e-6, 92e12 / 2.0
    fused_cost = 5 * macs / rate + len(gmap_f) * c_step
    twopass_cost = 7 * macs / rate + (len(s_dkv) + len(s_dq)) * c_step
    if fused_cost > twopass_cost:
        return False, bq2, 1, block_k, round_up(Lq, bq2), False
    return True, bq, pack, bk, pLq, hbm


def select_bwd_dkv_config(Lq, Lk, d, *, block_q, block_k, causal, q_offset,
                          itemsize, window=None):
    """``(q_pack, block_k, pLq)`` of the TPU's two-pass dK/dV kernel."""
    dwf = d + 1 if _fold_l(d) else d

    def footprint(bk, pack):
        score_tiles = 2 if pack == 1 else 4
        return (score_tiles * block_q * bk * 4
                + 2 * bk * dwf * 4
                + 4 * bk * d * itemsize
                + 6 * bk * d * itemsize
                + 4 * pack * block_q * d * itemsize)

    # The JAX package keeps the two-pass dK/dV unpacked (packed groups
    # measured slower on the TPU): its candidate loop has the one pack 1.
    cap = _FUSED_VMEM_CAP_FP32 if itemsize >= 4 else _FUSED_VMEM_CAP_BF16
    bk = block_k
    while bk > 512 and footprint(bk, 1) > cap:
        bk //= 2
    if footprint(bk, 1) > cap:
        return 1, min(block_k, 512), round_up(Lq, block_q)
    return 1, bk, round_up(Lq, block_q)


@functools.lru_cache(maxsize=256)
def two_pass(Lq: int, Lk: int, d: int, itemsize: int, causal: bool,
             q_offset: int | None = None, window: int | None = None) -> bool:
    """True where the JAX package's ``flash_attention_backward`` takes the
    two-pass form for these shapes, with the entry's default tiles and its
    clamps (``block_q=None``, ``block_k=2048`` cut to the 8-aligned Lk and,
    for fp32, to 512).  Cached: a training step asks once a layer."""
    block_k = min(DEFAULT_BLOCK_K_BWD, round_up(Lk, 8))
    if itemsize >= 4:
        block_k = min(block_k, 512)
    if q_offset is None:
        q_offset = Lk - Lq
    will_fuse, *_ = select_bwd_fused_config(
        Lq, Lk, d, block_q=None, block_k=block_k, causal=causal,
        q_offset=q_offset, itemsize=itemsize, window=window)
    return not will_fuse
