"""Host-precomputed getK value map — exact readK/prob per raw DB value.

merfin's readK is boundary-sensitive (merfin-globals.C:84-97): a
round(v/peak) half-way case decides the copy number.  So that no device
arithmetic (another backend's division, a compiler's rewrite) can move a
value across such a boundary, the whole v -> (readK, prob) function is
evaluated ONCE on the host with the reference's IEEE f64 expression for
every possible raw value and shipped to the device as gather tables.
Raw DB values are integers (kmvalu), so this is exact — and it also
deletes the division/rounding from the device hot path entirely.

readK values are integers <= 2^32 and are stored exactly.
Values above the cap (possible only via palindrome doubling beyond the
largest DB count) fall back to a device-side computation and are counted
so callers can warn.
"""

from __future__ import annotations

import numpy as np

from merfin_tpu.score.kstar import ProbTable, get_k_np


class ValueMap:
    """Gather tables: raw read-DB value -> (readK, prob)."""

    def __init__(self, peak: float, prob_table: ProbTable | None,
                 max_value: int, hard_cap: int = 1 << 22,
                 exact_max: bool = False):
        self.peak = float(peak)
        # fmer+rmer palindrome doubling can reach 2 * max DB value;
        # quantize to a power of two for compiled-program reuse
        vcap = int(min(max(2 * max_value, 2), hard_cap))
        self.vcap = max(2, 1 << (vcap - 1).bit_length())
        # exact_max: the caller asserts max_value is the TRUE DB maximum
        # (the CLI scans the DB); then no raw value can exceed vcap and
        # the device fallback division + overflow counter compile away.
        # Callers passing a guessed max keep the counted fallback.
        self.never_overflows = bool(exact_max) and self.vcap >= 2 * max_value
        v = np.arange(self.vcap + 1, dtype=np.uint64)
        read_k, _, prob = get_k_np(v, np.zeros_like(v), peak, prob_table)
        self.read_k_host = read_k          # float64, integer-valued (or inf)
        self.prob_host = prob
        # prob == 1.0 everywhere without a -prob table: consumers skip
        # the stale-prob forward-fill scans entirely then
        self.has_prob = prob_table is not None and len(prob_table) > 0

    def fits_u32(self, k: int) -> bool:
        """True when readK/asmK provably fit uint32 so positional
        fetches can ride the wire as u32 instead of f64.

        Requires never_overflows: when the overflow fallback can fire
        (raw value > vcap), readK = round(v/peak) is unbounded and a
        u32 cast would silently corrupt output.  With the fallback
        compiled away, table readK <= vcap/peak <= 2^22/0.01 < 2^32,
        and odd k forbids palindrome fmer+rmer doubling of asm_v
        beyond the single DB value (itself < 2^32).
        """
        return self.never_overflows and self.peak >= 0.01 and k % 2 == 1

    def f32_map_ok(self) -> bool:
        """True when the readK plane can ship as f32 without loss:
        every value is a finite integer < 2^24 (f32-exact) and the
        overflow fallback is compiled away.  Halves the bandwidth of
        the per-window readK gather; the consumer casts back to f64
        after the gather, bit-exactly."""
        return (self.never_overflows
                and bool(np.isfinite(self.read_k_host).all())
                and float(self.read_k_host.max()) < 2**24)

    def device_arrays(self):
        """(read_k[vcap+1], prob[vcap+1] f64) as jnp arrays; the readK
        plane is f32 when that is lossless (f32_map_ok), else f64.

        The f32 plane is cast back to f64 after the gather, so every
        downstream comparison stays in f64.  No caching: this is called both eagerly and under jit traces
        (where the result would be a leaked tracer if cached).
        """
        import jax.numpy as jnp

        if self.f32_map_ok():
            return (jnp.asarray(self.read_k_host.astype(np.float32)),
                    jnp.asarray(self.prob_host))
        return jnp.asarray(self.read_k_host), jnp.asarray(self.prob_host)

    def _int_map_ok(self) -> bool:
        """Every readK in the map is finite and fits int32."""
        return (bool(np.isfinite(self.read_k_host).all())
                and float(self.read_k_host.max()) < 2**31)

    def readk_bound(self) -> int | None:
        """Largest readK this map can emit, or None when unbounded
        (overflow fallback live or non-finite entries).  Trace-time
        bound for integer-only device paths."""
        if self.never_overflows and self._int_map_ok():
            return int(self.read_k_host.max())
        return None

    def int_scorer_ok(self) -> bool:
        """True when the fused scorers can run their integer fast path:
        no prob table (prob == 1 everywhere), no overflow fallback, and
        every readK fits int32 (_int_map_ok).  Then missing/K-delta
        math is pure integer arithmetic — EXACTLY equal to the host
        scorer's f64 sums of the same integers in any summation
        order."""
        return (not self.has_prob and self.never_overflows
                and self._int_map_ok())

    def device_arrays_scorer(self):
        """Scorer flavor of device_arrays: (readK i32, prob f64) when
        the integer fast path applies (consumers branch on the dtype at
        trace time), else the plain f64 pair."""
        import jax.numpy as jnp

        if self.int_scorer_ok():
            return (jnp.asarray(self.read_k_host.astype(np.int32)),
                    jnp.asarray(self.prob_host))
        return self.device_arrays()

    def lookup_jnp(self, seq_value, arrays=None):
        """Device getK via gather: (readK, prob, overflow_count).

        seq_value: uint64 raw values (already fmer+rmer summed).
        Values above vcap use the counted device-float fallback.
        Pass ``arrays=device_arrays()`` through an outer jit so the maps
        ride as arguments instead of baked-in constants.
        """
        import jax.numpy as jnp

        rk_map, pr_map = arrays if arrays is not None else self.device_arrays()
        v = seq_value.astype(jnp.int64)
        idx = jnp.minimum(v, self.vcap)
        read_k = rk_map[idx]
        if read_k.dtype != jnp.float64:
            # integer or f32 wire plane: widen after the gather
            # (lossless — f32 planes hold integers < 2^24)
            read_k = read_k.astype(jnp.float64)
        if self.has_prob:
            prob = pr_map[idx]
        else:
            # no -prob table: the map is all ones — skip the per-window
            # f64 gather entirely (trace-time)
            prob = jnp.ones(read_k.shape, jnp.float64)
        if self.never_overflows:
            # vcap covers 2x the true DB max: the clamp above is pure
            # safety, the device fallback division never runs
            return read_k, prob, jnp.int64(0)
        over = v > self.vcap
        if self.peak != 0:
            fb = jnp.floor(v.astype(jnp.float64) / self.peak + 0.5)
        else:
            fb = jnp.where(v > 0, jnp.inf, 0.0)
        read_k = jnp.where(over, fb, read_k)
        prob = jnp.where(over, 1.0, prob)
        return read_k, prob, jnp.sum(over)
