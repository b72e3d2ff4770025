"""merfin_tpu — a k-mer validation engine on an accelerator (JAX/XLA).

A from-scratch reimplementation of the capabilities of Merfin
(arangrhie/merfin: k-mer validated variant filtering, assembly evaluation
and polishing) built as array programs: k-mer databases live as sharded
sorted-array lookup tables in device memory, sequence and variant windows
stream through batched data-parallel programs under ``jit``/``shard_map``,
and all statistics merge via collective reductions.

Reference semantics are documented per-module with citations into the
reference tree (``/root/reference``, file:line).
"""

__version__ = "0.1.0"

from merfin_tpu.config import MerfinConfig, ensure_x64  # noqa: F401
