"""Exact QV* excess accumulation (koverCpy) — integer device parts.

The reference accumulates koverCpy += (1 - readK/asmK) * prob per undr
k-mer in f64 (merfin-histogram.C:81), in sequence order.  A device sum
runs in another order (and another backend may compute the per-window
term differently), so it can differ from the reference's doubles in the
last bits.  The fix: never sum floats on the device.  Each undr
window's term is a pure function of small integers —

  * in-prob-table values (raw v <= len(table)): term depends only on
    (v, asmK); count windows per (v, asmK) pair;
  * everything else: prob == 1 and term = 1 - readK/asmK; per asmK,
    count windows and sum readK (both integers).

One (key, payload) device sort + cumsum + boundary gathers produce the
integer parts (scatter-free, like two_hist_by_sort); the host finishes
kover = sum C[v,a]*(1-copyK[v]/a)*copyP[v] + sum_a (N[a] - R[a]/a) in
exact IEEE, identically on every backend.  Windows outside the covered
ranges (asmK > amax, prob rows beyond vmaxp, readK >= 2^30) keep the
counted device-float fallback.

Cross-backend note: the finished value is deterministic and
backend-independent; it may differ from the reference binary in final
ulps because the summation ORDER differs (the reference sums per-window
in thread order, itself nondeterministic across -threads settings).
"""

from __future__ import annotations

import numpy as np

VMAXP_CAP = 16   # prob-table rows covered exactly (GenomeScope tables
                 # are ~4-10 rows; longer tables fall back per-window)
RMAX_PLAIN = 1 << 30   # readK payload must fit the i32 sort lane


def kover_vmaxp(prob_table) -> int:
    """Exact-v rows for this table (0 without a table)."""
    if prob_table is None or len(prob_table) == 0:
        return 0
    return min(VMAXP_CAP, len(prob_table))


def kover_parts(read_v, read_k, asm_k, prob, is_undr, vmaxp: int,
                amax: int, r_max: int | None = None,
                a_max: int | None = None):
    """Device: integer kover parts + the float fallback sum.

    read_v: raw summed DB values (what getK indexed); read_k/asm_k/prob:
    getK outputs; is_undr: the undr classification mask.
    Returns (C [vmaxp*(amax+1)] i64, N [amax+1] i64, R [amax+1] i64,
             fb_sum f64, fb_count i64).

    ``r_max``/``a_max`` are TRACE-TIME bounds (largest possible readK /
    asmK): when they prove the float fallback unreachable (no prob
    table, readK < RMAX_PLAIN, asmK <= amax), the per-window f64 term
    is not built at all, and a small enough r_max narrows the prefix
    cumsum from i64 to i32.
    """
    import jax
    import jax.numpy as jnp

    A1 = amax + 1
    v = read_v.reshape(-1).astype(jnp.int64)
    r = read_k.reshape(-1)
    a = asm_k.reshape(-1)
    undr = is_undr.reshape(-1)

    no_fb = (vmaxp == 0 and r_max is not None and r_max < RMAX_PLAIN
             and a_max is not None and a_max <= amax)
    if no_fb:
        # every undr window is a plain row: prob == 1 (no table),
        # r < RMAX_PLAIN and a <= amax by the caller's DB bounds
        exact_v = jnp.zeros_like(undr)
        plain = undr
        fb = jnp.zeros_like(undr)
    else:
        a_ok = undr & (a <= amax)
        if vmaxp:
            exact_v = a_ok & (v >= 1) & (v <= vmaxp)
        else:
            exact_v = jnp.zeros_like(a_ok)
        plain = a_ok & ~exact_v & (v > vmaxp) & (r < RMAX_PLAIN)
        # v in (vmaxp, len(table)] still has table prob: only safe when
        # the caller sized vmaxp == len(table); larger tables route
        # those rows to the fallback via the prob != 1 test below.
        plain = plain & (prob.reshape(-1) == 1.0)
        fb = undr & ~exact_v & ~plain

    a32 = a.astype(jnp.int32)
    sentinel = vmaxp * A1 + A1
    key = jnp.where(exact_v, (v.astype(jnp.int32) - 1) * A1 + a32,
                    jnp.where(plain, vmaxp * A1 + a32, sentinel))
    r32 = jnp.where(plain, r, 0.0).astype(jnp.int32)
    # keys span [0, sentinel]: u16 lanes when that fits (vmaxp <= 6 at
    # the default amax) — half the key bandwidth of the kover sort
    kdt = jnp.uint16 if sentinel <= 0xFFFF else jnp.int32
    ks, rs = jax.lax.sort((key.astype(kdt), r32), num_keys=1)

    # counts + per-key r sums via run-length compaction + one SMALL
    # scatter.  NOTE the asymmetry with engine.counts_by_sort: the hist
    # composite (32k edges, counts only) measured FASTER with a
    # boundary searchsorted, while kover (counts AND r-sums) measured
    # faster compacted — e2e chip A/Bs 14.5 vs 12.7M bases/s flipping
    # the hist side, and 12.7 vs 14.5 flipping this one back (r5).
    W = ks.shape[0]
    pos = jnp.arange(W, dtype=jnp.int32)
    b = jnp.concatenate([jnp.ones(1, bool), ks[1:] != ks[:-1]])
    bp = jnp.sort(jnp.where(b, pos, np.int32(W)))
    M = min(sentinel + 1, W)
    runs_pos = bp[:M]
    runs_next = bp[1: M + 1] if M < W else jnp.append(bp[1:M], np.int32(W))
    lens = (runs_next - runs_pos).astype(jnp.int64)       # pads: 0
    kvals = ks[jnp.minimum(runs_pos, W - 1)].astype(jnp.int32)
    # i32 prefix sum when the trace-time bound proves no overflow
    cdt = (jnp.int32 if r_max is not None and r_max * W < 2**31
           else jnp.int64)
    csr = jnp.pad(jnp.cumsum(rs.astype(cdt)), (1, 0))
    rsum_run = (csr[runs_next] - csr[runs_pos]).astype(jnp.int64)
    counts = jnp.zeros(sentinel + 1, jnp.int64).at[kvals].add(lens)
    rsum = jnp.zeros(sentinel + 1, jnp.int64).at[kvals].add(rsum_run)

    C = counts[: vmaxp * A1]
    N = counts[vmaxp * A1: vmaxp * A1 + A1]
    R = rsum[vmaxp * A1: vmaxp * A1 + A1]

    if no_fb:
        return C, N, R, jnp.float64(0.0), jnp.int64(0)
    prob_f = prob.reshape(-1)
    safe_a = jnp.where(a > 0, a, 1.0)
    term = (1.0 - r / safe_a) * prob_f
    fb_sum = jnp.sum(jnp.where(fb, term, 0.0))
    return C, N, R, fb_sum, jnp.sum(fb)


def finish_kover(C: np.ndarray, N: np.ndarray, R: np.ndarray,
                 fb_sum: float, prob_table, vmaxp: int,
                 amax: int) -> float:
    """Host: exact IEEE finish of the integer parts (+ the fallback)."""
    A1 = amax + 1
    a = np.arange(A1, dtype=np.float64)
    total = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        if vmaxp:
            Cm = np.asarray(C, dtype=np.float64).reshape(vmaxp, A1)
            ck = prob_table.copy_k[:vmaxp].astype(np.float64)[:, None]
            cp = np.asarray(prob_table.copy_p[:vmaxp],
                            dtype=np.float64)[:, None]
            terms = (1.0 - ck / a[None, :]) * cp
            total += float(np.sum(np.where(Cm > 0, Cm * terms, 0.0)))
        Nf = np.asarray(N, dtype=np.float64)
        Rf = np.asarray(R, dtype=np.float64)
        total += float(np.sum(np.where(Nf > 0, Nf - Rf / a, 0.0)))
    return total + float(fb_sum)
