"""Global configuration for merfin_tpu.

The engine needs 64-bit integers for k-mer keys (k <= 31 -> 62 bits) and
float64 for QV/K* accumulation that tracks the reference's C++ doubles
(reference: merfin-histogram.C:22-31 computes QV in double precision).
``ensure_x64`` must be called before any jax arrays are created.
"""

from __future__ import annotations

import dataclasses
import os


def ensure_x64() -> None:
    """Enable 64-bit types in jax (idempotent, safe pre- or post-import)."""
    import jax

    jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else the fixed ``<repo>/.jax_cache``.
    A fixed path lets later runs of the same checkout hit the cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache")


def setup_runtime() -> None:
    """Full runtime config: x64 + persistent compilation cache."""
    import jax

    ensure_x64()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


# Maximum k supported with single-word uint64 keys: 2k <= 62 so that keys
# stay positive in int64 contexts as well.  The reference supports larger k
# through meryl's multi-word kmers; k in practice is 21 (README.md:33).
KMAX = 31


@dataclasses.dataclass
class MerfinConfig:
    """Mirrors the reference CLI parameter set (merfin.C:80-155).

    Attributes map 1:1 onto ``merfinGlobal`` fields
    (merfin-globals.H:132-244).
    """

    # inputs
    seq_name: str | None = None          # -sequence
    seq_db_name: str | None = None       # -seqmers
    read_db_name: str | None = None      # -readmers
    vcf_name: str | None = None          # -vcf
    out_name: str | None = None          # -output
    prob_table: str | None = None        # -prob

    # k* parameters
    peak: float = 0.0                    # -peak
    min_v: int = 0                       # -min  (read DB only, merfin-globals.C:136)
    max_v: int = 2**64 - 1               # -max  (read DB only)

    # run-time parameters
    threads: int = 0                     # -threads (0 = auto)
    max_memory_gb: float = 0.0           # -memory  (0 = auto)

    # variant-mode parameters
    nosplit: bool = False                # -nosplit
    comb: int = 15                       # -comb   (merfin-globals.H:241)
    debug: bool = False                  # -debug
    resume: bool = False                 # -resume (extension: sequence-level checkpoint/restart)
    mesh: str | None = None              # -mesh DxT (extension: shard tables over a device mesh)
    devscore: bool | None = None         # -devscore/-nodevscore (None = auto:
                                         #  fused device scoring for the numM-only
                                         #  modes, host scoring for -polish/-debug)
    skip_missing: bool = False           # -skipMissing

    # report type: one of hist|completeness|dump|filter|polish|better|strict|loose
    report_type: str | None = None

    def __post_init__(self) -> None:
        if self.max_memory_gb <= 0:
            self.max_memory_gb = _default_memory_gb()


def _default_memory_gb() -> float:
    """Default memory budget, like getMaxMemoryAllowed() (merfin-globals.H:232)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return float(os.environ.get("MERFIN_TPU_MEMORY_GB", 16.0))
