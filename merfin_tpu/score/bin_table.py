"""Host-precomputed histogram bin tables — exact C float semantics.

The -hist bin index trunc((asmK/readK - 1 + 0.1) / 0.2)
(merfin-histogram.C:72,85) is decided by IEEE f64 division and sits on a
truncation boundary for ratios like 3/2 (w = 3.0000000000000004 in
IEEE), where any other evaluation order lands one bin away.  Both readK
and asmK are integer-valued, so the whole decision is tabulated on the
host with the reference's expression and gathered on device:

    undr_table[r, a] = C bin of (readK=r, asmK=a)   r in [0,RMAX], a in [0,AMAX]
    over_table[a, r] = C bin of (readK=r, asmK=a)   (the readK>asmK side)

Out-of-range pairs (huge ratios, vanishingly rare) fall back to the
device float expression and are counted so callers can warn.
"""

from __future__ import annotations

import numpy as np

RMAX = 64       # readK range covered exactly (peak-normalized copies)
AMAX = 8192     # asmK range covered exactly


class BinTable:
    def __init__(self, rmax: int = RMAX, amax: int = AMAX):
        self.rmax = rmax
        self.amax = amax
        r = np.arange(rmax + 1, dtype=np.float64)[:, None]
        a = np.arange(amax + 1, dtype=np.float64)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            undr = np.trunc((a / r - 1.0 + 0.1) / 0.2)
            over = np.trunc((r / a - 1.0 + 0.1) / 0.2)
        # clamp negatives to 0: a (r, a) entry is negative only on the
        # side that never selects it (undr needs a > r -> value > 0 and
        # vice versa), so the clamp is unobservable — and it lets the
        # device planes be u16 (max undr bin ~(amax-1+0.1)/0.2 < 2^16),
        # halving the per-window gather bandwidth of the bin lookups
        self.undr_host = np.maximum(
            np.nan_to_num(undr, nan=0.0, posinf=0.0), 0.0).astype(np.int32)
        self.over_host = np.maximum(
            np.nan_to_num(over, nan=0.0, posinf=0.0), 0.0).astype(np.int32)
        assert int(self.undr_host.max()) <= 0xFFFF
        assert int(self.over_host.max()) <= 0xFFFF

    def device_arrays(self):
        import jax.numpy as jnp

        return (jnp.asarray(self.undr_host.reshape(-1).astype(np.uint16)),
                jnp.asarray(self.over_host.reshape(-1).astype(np.uint16)))

    def lookup_jnp(self, read_k, asm_k, arrays=None):
        """(undr_idx, over_idx, in_range) for integer-valued f64 inputs.

        Out-of-range entries return the f32 fallback index (native-rate
        and IEEE-f32 deterministic across backends) and in_range False.
        """
        import jax.numpy as jnp

        undr_t, over_t = arrays if arrays is not None else self.device_arrays()
        r = read_k.astype(jnp.int32)
        a = asm_k.astype(jnp.int32)
        in_range = (
            (read_k <= self.rmax) & (asm_k <= self.amax)
            & (read_k == r.astype(read_k.dtype))     # integer-valued
            & (asm_k == a.astype(asm_k.dtype))
        )
        rc = jnp.clip(r, 0, self.rmax)
        ac = jnp.clip(a, 0, self.amax)
        exact_undr = undr_t[rc * (self.amax + 1) + ac].astype(jnp.int32)
        exact_over = over_t[rc * (self.amax + 1) + ac].astype(jnp.int32)

        # Out-of-range fallback, computed in f32: IEEE-f32 divisions are
        # DETERMINISTIC on every backend.  Fallback bins are counted
        # (bin_fallbacks); boundary-ratio pairs may land one bin away
        # from the reference's f64 expression.  Handles inf readK
        # (peak=0) like the float expression always did.
        rf = read_k.astype(jnp.float32)
        af = asm_k.astype(jnp.float32)
        safe_r = jnp.where(rf > 0, rf, jnp.float32(1.0))
        safe_a = jnp.where(af > 0, af, jnp.float32(1.0))
        fb_undr = jnp.trunc(
            (af / safe_r - jnp.float32(0.9)) / jnp.float32(0.2)
        ).astype(jnp.int32)
        fb_over = jnp.trunc(
            (rf / safe_a - jnp.float32(0.9)) / jnp.float32(0.2)
        ).astype(jnp.int32)

        undr_idx = jnp.where(in_range, exact_undr, fb_undr)
        over_idx = jnp.where(in_range, exact_over, fb_over)
        return undr_idx, over_idx, in_range
