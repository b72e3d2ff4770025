"""Variant report modes: -filter / -polish / -better / -strict / -loose.

Driver shape follows processVariants/outputVariants
(merfin-variants.C:131-345):

  for each sequence with clusters:
    window = cluster span padded by k-1 each side (uint32-clamped),
    PANIC-skip invalid regions and clusters with more than `comb`
    variants, enumerate REF/ALT paths, score, select by mode.

All clusters of a sequence are enumerated first, then scored through one
batched table-lookup dispatch (splitting at ~`query_budget` k-mers), then
selected in order — preserving output and debug-log determinism (single-
writer order; the reference runs this out-of-order across threads).

Output file naming preserves the reference quirk: `<out>.polish.vcf` for
-polish only, `<out>.filter.vcf` for every other mode including
-better/-strict/-loose (merfin-variants.C:320-334).  Input headers are
replayed verbatim.
"""

from __future__ import annotations

import sys

from merfin_tpu.io.compressed import open_write_text
from merfin_tpu.io.fasta import SeqFile, Sequence
from merfin_tpu.io.vcf import VcfFile, PosGT
from merfin_tpu.score.kstar import ProbTable
from merfin_tpu.variants.enumerate import enumerate_paths, VarPath
from merfin_tpu.variants.score import (score_path_groups, PathScore,
                                       build_path_block, dispatch_blocks,
                                       fetch_blocks)
from merfin_tpu.variants import select

_U32 = 1 << 32


def cluster_window(pos_gt: PosGT, k: int, seq_len: int) -> tuple[int, int]:
    """Padded window coordinates (merfin-variants.C:166-176), with the
    reference's uint32 arithmetic at the boundaries."""
    k_padd = k - 1
    r_start = pos_gt.r_start
    r_end = pos_gt.r_end
    if r_start > k_padd:
        r_start -= k_padd
    else:
        r_start = 0
    # uint32: seq_len - k_padd underflows for seq_len < k_padd
    limit = (seq_len - k_padd) % _U32
    if r_end < limit:
        r_end += k_padd
    else:
        r_end = seq_len
    return r_start, r_end


def prepare_cluster_args(
    seq: Sequence, pos_gt: PosGT, k: int, comb: int, log=sys.stderr
) -> tuple[int, int, tuple] | None:
    """Window math + PANIC checks for one cluster; returns
    (r_start, r_end, enumerate_paths args) or None on PANIC-skip.  The
    (CPU-heavy) enumeration itself runs separately so -threads can fan it
    out over worker processes."""
    r_start, r_end = cluster_window(pos_gt, k, seq.length)

    ref_idx = [(gt.pos - r_start) % _U32 for gt in pos_gt.gts]
    ref_len = [gt.ref_len for gt in pos_gt.gts]
    haps = [gt.alleles for gt in pos_gt.gts]

    template = seq.copy_region(r_start, r_end)
    if template is None:
        print(f"PANIC : Invalid region specified: {seq.ident} : {r_start} - {r_end}",
              file=log)
        return None

    if len(ref_idx) > comb:
        print(f"PANIC : Combination {seq.ident}:{r_start}-{r_end} has too many "
              f"variants ( found {len(pos_gt.gts)} > {comb} ) to evaluate. "
              f"Consider filtering the vcf upfront. Skipping...", file=log)
        return None

    return r_start, r_end, (template.decode("ascii"), ref_idx, ref_len, haps)


def prepare_cluster(
    seq: Sequence, pos_gt: PosGT, k: int, comb: int, log=sys.stderr
) -> tuple[int, int, list[VarPath]] | None:
    """Enumerate one cluster; None on PANIC-skip."""
    r = prepare_cluster_args(seq, pos_gt, k, comb, log=log)
    if r is None:
        return None
    return r[0], r[1], _enumerate_task(r[2])


_POOL_MIN_PATHS = 64   # ship a cluster to a worker only past this size


def _est_paths(haps) -> int:
    """Upper bound on enumerated paths for a cluster (product of allele
    counts, capped)."""
    est = 1
    for h in haps:
        est *= max(1, len(h))
        if est >= 1 << 20:
            break
    return est


def _enumerate_task(args):
    """Worker task: REF/ALT path enumeration (merfin-variants.C:22-126)."""
    if args is None:
        return None
    template, ref_idx, ref_len, haps = args
    return enumerate_paths(template, ref_idx, ref_len, haps)


def _enumerate_block_task(args):
    """Worker task for the fused-scorer path: the array-native
    enumeration (variants/enumerate_fast.py — no per-path Python
    objects; ~15x the scalar traverse at comb=15 scale) builds the
    PathBlock directly, so the stream assembly and adjust-plane build
    parallelize across clusters and the result pickles as numpy
    buffers."""
    if args is None:
        return None
    enum_args, k = args
    from merfin_tpu.variants.enumerate_fast import build_path_block_fast

    return build_path_block_fast(*enum_args, k)


def _select_block_task(args):
    """Array-native twin of _select_task over a PathBlock + its device-
    reduced (num_m, totdk) arrays."""
    import io as _io

    mode, block, scores, pos_gt, k = args
    nm, td = scores
    warn = _io.StringIO()
    res = select.select_block(mode, nm, td, block.lens, block.gtp,
                              pos_gt, k, log=warn)
    if isinstance(res, list):     # filter mode returns records
        res = "".join(r.save() for r in res)
    return res, warn.getvalue()


def _select_task(args):
    """Worker task: per-cluster mode selection -> (result text, warnings).

    Pure function of the scored paths; loose-mode warnings come back as
    text so the parent prints them in deterministic order.
    """
    import io as _io

    mode, paths, scores, pos_gt, k = args
    warn = _io.StringIO()
    if mode == "polish":
        res = select.best_variant(paths, scores, pos_gt, k)
    elif mode == "better":
        res = select.better_variant(paths, scores, pos_gt, k)
    elif mode == "strict":
        res = select.strict_polish(paths, scores, pos_gt, k)
    elif mode == "loose":
        res = select.loose_polish(paths, scores, pos_gt, k, log=warn)
    else:
        recs = select.best_filter(paths, scores, pos_gt, k)
        res = "".join(r.save() for r in recs)
    return res, warn.getvalue()


class DebugWriter:
    """Per-path debug log (merfin-variants.C:240-276).

    The reference writes one gz per worker thread with thread-local
    sequential varMerIds; here the analog writer unit is the process:
    single-host runs land everything in `<out>.00.debug.gz`, multi-host
    striped runs write `<out>.<RANK>.debug.gz` per rank (each covering
    that rank's sequence stripe, rank-local sequential ids — exactly the
    reference's per-thread split).
    """

    def __init__(self, out_name: str, writer_id: int = 0):
        self.file = open_write_text(f"{out_name}.{writer_id:02d}.debug.gz")
        self.var_mer_id = 0

    def emit(self, ident: str, r_start: int, r_end: int, pos_gt: PosGT,
             paths: list[VarPath], scores: list[PathScore]) -> None:
        for p, s in zip(paths, scores):
            parts = [
                f"{self.var_mer_id}\t{ident}:{r_start}-{r_end}\t{p.seq}\t{s.num_m}\t"
                f"{select.min_abs_k(s):.5f}\t{select.max_abs_k(s):.5f}\t"
                f"{select.med_abs_k(s):.5f}\t{select.avg_abs_k(s):.5f}\t"
                f"{select.tot_dk(s):.5f}\t"
            ]
            self.var_mer_id += 1
            for i, alt_idx in enumerate(p.gt_path):
                if alt_idx > 0:
                    gt = pos_gt.gts[i]
                    parts.append(f"{pos_gt.chrom} {gt.pos + 1} . "
                                 f"{gt.alleles[0]} {gt.alleles[alt_idx]} . PASS . GT 1/1  ")
            parts.append("\n")
            self.file.write("".join(parts))

    def close(self) -> None:
        self.file.close()


def pin_cpu_worker() -> None:
    """Pool initializer: keep a worker process off the accelerator."""
    import os as _os

    _os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def run_variants(
    mode: str,
    seq_file: SeqFile,
    vcf: VcfFile,
    k: int,
    lookup_read,
    lookup_asm,
    peak: float,
    prob_table: ProbTable | None,
    out_name: str,
    comb: int = 15,
    debug: bool = False,
    log=sys.stderr,
    query_budget: int = 1 << 23,
    resume: bool = False,
    threads: int = 1,
    spans: bool = False,
    scorer=None,
):
    """Variant-mode driver.  ``threads`` > 1 fans the CPU-bound stages
    (path enumeration, mode selection) over worker processes — the
    sweatShop worker count analog (merfin.C:400-413); table lookups stay
    batched on the device in the parent.  Output order is deterministic
    regardless of thread count (ordered map)."""
    import os as _os

    from merfin_tpu.utils.checkpoint import Checkpoint, truncate_to

    assert mode in ("filter", "polish", "better", "strict", "loose")
    if debug and scorer is not None:
        # not an assert: the device scorer reduces num_m/totdk on device
        # and leaves the per-window kstr arrays empty, so -debug output
        # would be silently wrong (and asserts vanish under python -O)
        raise ValueError("-debug needs per-window K* stats; "
                         "it cannot run with the device scorer (-devscore)")
    filter_mode = mode == "filter"

    if not threads:   # 0 = auto, like getMaxThreadsAllowed (merfin.C:108)
        threads = _os.cpu_count() or 1

    pool = None

    def get_pool():
        """Spawn the worker pool on first heavy cluster (spawn startup is
        ~1s; a run of all-light clusters never pays it).  spawn, not
        fork: the parent holds live device runtime state.  Workers are
        pinned to the CPU platform: each process that opens an
        accelerator reserves most of its memory."""
        nonlocal pool
        if pool is None and threads and threads > 1:
            import multiprocessing as mp

            pool = mp.get_context("spawn").Pool(threads,
                                                initializer=pin_cpu_worker)
        return pool

    suffix = "polish" if mode == "polish" else "filter"
    out_path = f"{out_name}.{suffix}.vcf"
    out = None  # lazily opened, like outputVariants (merfin-variants.C:321)

    # Multi-host, two shapes:
    #  * striped — sequence stripes -> per-process part files (no
    #    headers) -> ordered merge with headers by rank 0;
    #  * ``spans`` (host-spanning mesh lookups) — the sharded table
    #    needs every process in each collective, so all ranks evaluate
    #    every cluster (the table memory, not host CPU, is what the
    #    global mesh buys) and only rank 0 writes.
    from merfin_tpu.parallel import multihost as mh

    multi = mh.is_active()
    part = None
    pid, pcount = 0, 1
    if multi:
        pid, pcount = mh.process_info()

    # Debug writers follow the reference's per-thread split (one gz per
    # writer unit, local sequential ids): per rank for striped runs; in
    # spans mode every rank evaluates identically, so only rank 0 writes.
    if debug and multi and spans and pid != 0:
        dbg = None
    elif debug:
        dbg = DebugWriter(out_name, pid if (multi and not spans) else 0)
    else:
        dbg = None

    # Checkpoint/resume at the sequence boundary (not combinable with
    # -debug: the per-thread debug gz stream is not offset-restartable).
    # Multi-host: striped ranks keep independent per-rank checkpoints
    # plus resumable part files (no collectives run inside the striped
    # loop, so ranks resume wherever each one stopped); spans ranks all
    # drive the same sequences, so they share rank 0's checkpoint on the
    # shared filesystem and only rank 0 writes it (utils/checkpoint.py).
    striped = multi and not spans
    ckpt = Checkpoint(f"{out_name}.rank{pid}" if striped else out_name,
                      f"variants-{mode}",
                      enabled=resume and not debug,
                      writer=striped or (not multi) or pid == 0)
    skip = 0
    part_resume = None
    n_selected = 0
    if resume and not debug and (st := ckpt.load()) is not None:
        skip = st["seqs_done"]
        n_selected = st["accum"].get("records", 0)
        if striped:
            part_resume = (st["accum"].get("n_extents", 0),
                           st["output_offset"])
            from merfin_tpu.utils.partmerge import can_resume_part

            if not can_resume_part(out_path, pid, *part_resume):
                # torn part/idx state on disk: restart this rank's
                # stripe from scratch rather than silently dropping the
                # checkpointed rows from the merged output
                print("-- Part file state unusable; restarting this "
                      "rank's stripe fresh.", file=log)
                skip = 0
                part_resume = None
                n_selected = 0
        elif not multi or pid == 0:
            truncate_to(out_path, st["output_offset"])
        if skip:
            print(f"-- Resuming after {skip} sequences.", file=log)
    if striped:
        from merfin_tpu.utils.partmerge import PartWriter

        part = PartWriter(out_path, pid, resume_state=part_resume)

    def ensure_out():
        nonlocal out
        if out is None:
            if skip > 0:
                out = open(out_path, "ab")
            else:
                out = open(out_path, "wb")
                for h in vcf.headers:
                    out.write(h.encode() + b"\n")
        return out

    seq_idx = 0
    for seq in seq_file:
        seq_idx += 1
        if seq_idx <= skip:
            continue
        if multi and not spans and (seq_idx - 1) % pcount != pid:
            continue
        # The reference's writer opens the output (headers included) for
        # the first sequence regardless of whether it has any variants
        # (outputVariants runs per sequence, merfin-variants.C:313-341).
        if not multi or (spans and pid == 0):
            ensure_out()
        clusters = vcf.by_chrom.get(seq.ident)
        if clusters is None:
            if out is not None:
                ckpt.save(seq_idx, out.tell(), {"records": n_selected})
            continue
        print(f"Processing sequence {seq.ident} for variants", file=log)

        # window math + PANIC checks (needs the sequence; cheap)
        prepared: list[tuple[PosGT, int, int, tuple] | None] = []
        for pos_gt in clusters:
            r = prepare_cluster_args(seq, pos_gt, k, comb, log=log)
            prepared.append(None if r is None else (pos_gt, r[0], r[1], r[2]))

        # enumerate REF/ALT paths — CPU-bound, fans out over the pool.
        # Only combinatorially heavy clusters go to workers: for small
        # ones the pickle round-trip costs more than the enumeration.
        # With a fused device scorer, workers return array-native
        # PathBlocks (variants/score.py) instead of VarPath lists: a
        # comb=15 cluster crosses the process boundary as five numpy
        # buffers, not 165k dataclasses, and selection reads the arrays
        # directly (select.select_block).
        use_blocks = scorer is not None
        enum_args = [p[3] if p is not None else None for p in prepared]
        task_fn = _enumerate_block_task if use_blocks else _enumerate_task
        task_args = [(a, k) if a is not None and use_blocks else a
                     for a in enum_args]
        paths_list = [None] * len(enum_args)
        # Pool threshold: the scalar path wins from 2 workers; the fused
        # path's array-native enumeration is ~6x faster, so the spawn +
        # PathBlock-pickle overhead only pays off from 3+ workers
        min_workers = 3 if use_blocks else 2
        heavy = [i for i, a in enumerate(enum_args)
                 if a is not None and _est_paths(a[3]) >= _POOL_MIN_PATHS] \
            if threads and threads >= min_workers else []
        heavy_set = set(heavy)
        all_scores: list = [None] * len(prepared)

        selected_map: dict[int, tuple[str, str]] = {}
        if use_blocks:
            # Pipelined three ways: heavy blocks stream (in order) from
            # the process pool when it's engaged, OTHER clusters build on
            # a background thread (enumerate_fast's numpy + native
            # assembly release the GIL, so build(j+1) overlaps the
            # parent's dispatch/fetch/selection of j even on a 2-core
            # host); each budgeted batch DISPATCHES as soon as its
            # blocks exist; and selection runs EAGERLY per fetched batch
            # instead of after the whole sequence, so it hides inside
            # later batches' device time.  Fetches trail by up to
            # _MAX_INFLIGHT batches to bound in-flight input buffers.
            import collections
            from concurrent.futures import ThreadPoolExecutor

            heavy_iter = iter(get_pool().imap(
                task_fn, [task_args[i] for i in heavy])) if heavy else None
            build_ex = ThreadPoolExecutor(max_workers=1)
            _LOOKAHEAD = 4
            futs: collections.deque = collections.deque()
            nxt = 0

            def submit_more():
                nonlocal nxt
                while nxt < len(prepared) and len(futs) < _LOOKAHEAD:
                    if nxt in heavy_set:
                        futs.append((nxt, None))   # drawn from heavy_iter
                    else:
                        futs.append((nxt, build_ex.submit(task_fn,
                                                          task_args[nxt])))
                    nxt += 1

            def next_block():
                submit_more()
                idx, f = futs.popleft()
                b = next(heavy_iter) if f is None else f.result()
                submit_more()
                return idx, b

            def finish(a, bb, tok):
                all_scores[a:bb] = fetch_blocks(tok, scorer)
                for idx in range(a, bb):
                    if prepared[idx] is not None:
                        selected_map[idx] = _select_block_task(
                            (mode, paths_list[idx], all_scores[idx],
                             prepared[idx][0], k))

            pending: list[tuple[int, int, tuple]] = []
            _MAX_INFLIGHT = 8

            try:
                i = 0
                while i < len(prepared):
                    j = i
                    budget = 0
                    batch: list = []
                    while j < len(prepared) and (budget == 0
                                                 or budget < query_budget):
                        jj, b = next_block()
                        assert jj == j
                        paths_list[j] = b
                        if b is not None:
                            budget += int(b.nis.sum())
                        batch.append(b)
                        j += 1
                    pending.append((i, j, dispatch_blocks(batch, scorer, k)))
                    if len(pending) > _MAX_INFLIGHT:
                        finish(*pending.pop(0))
                    i = j
                for p in pending:
                    finish(*p)
            finally:
                # bound leaked lookahead work if the device/selection
                # path raises mid-sequence
                build_ex.shutdown(wait=False, cancel_futures=True)
        else:
            if heavy:
                async_res = get_pool().map_async(
                    task_fn, [task_args[i] for i in heavy])
                for i, a in enumerate(task_args):
                    if i not in heavy_set:
                        paths_list[i] = task_fn(a)
                for i, r in zip(heavy, async_res.get()):
                    paths_list[i] = r
            else:
                paths_list = [task_fn(a) for a in task_args]

            # score in budgeted batches (device lookups, parent process)
            i = 0
            while i < len(prepared):
                j = i
                budget = 0
                groups: list = []
                while j < len(prepared) and (budget == 0
                                             or budget < query_budget):
                    pb = paths_list[j]
                    if pb is not None:
                        budget += sum(max(0, len(p.seq) - k + 1)
                                      for p in pb)
                        groups.append(pb)
                    else:
                        groups.append([])
                    j += 1
                all_scores[i:j] = score_path_groups(
                    groups, k, lookup_read, lookup_asm, peak, prob_table,
                    filter_mode, threads=max(1, threads), scorer=scorer
                )
                i = j

        # per-cluster selection — runs in the parent: once the scores
        # exist, selection is an integer scan over num_m plus tot_dk
        # sums for the (small) min-missing tie set; shipping the
        # per-window score arrays to a worker costs orders of magnitude
        # more in pickling than the scan itself (measured: ~90 MB/cluster
        # at comb=15), so the pool fans out enumeration only.  The fused
        # path selected eagerly per fetched batch above.
        if use_blocks:
            selected = [selected_map[idx]
                        for idx, entry in enumerate(prepared)
                        if entry is not None]
        else:
            tasks = [(mode, paths_list[idx], all_scores[idx], entry[0], k)
                     for idx, entry in enumerate(prepared)
                     if entry is not None]
            selected = [_select_task(t) for t in tasks]

        result_parts: list[str] = []
        si = 0
        for idx, entry in enumerate(prepared):
            if entry is None:
                continue
            pos_gt, r_start, r_end, _ = entry
            if dbg is not None:
                dbg.emit(seq.ident, r_start, r_end, pos_gt,
                         paths_list[idx], all_scores[idx])
            res, warn = selected[si]
            si += 1
            if warn:
                log.write(warn)
            result_parts.append(res)

        text = "".join(result_parts)
        n_selected += text.count("\n")
        if part is not None:
            part.write_seq(seq_idx, text.encode())
            if ckpt.enabled:
                part.flush_idx()
                ckpt.save(seq_idx, part.offset,
                          {"n_extents": len(part.extents),
                           "records": n_selected})
        elif not multi or pid == 0:
            f = ensure_out()
            f.write(text.encode())
            f.flush()
            ckpt.save(seq_idx, f.tell(), {"records": n_selected})

    if pool is not None:
        pool.close()
        pool.join()
    if out is not None:
        out.close()
    if part is not None:
        part.close()
    if multi and spans:
        mh.barrier("variants-spans-done")   # ranks computed identically
    elif multi:
        from merfin_tpu.utils.partmerge import merge_parts

        n_selected = int(mh.merge_scalar_across_hosts(n_selected))
        mh.barrier("variants-parts")
        # drop per-rank checkpoints BEFORE the merge consumes the parts:
        # a crash inside the merge window re-runs from scratch instead of
        # resuming against missing part files (utils/checkpoint.py).
        ckpt.done()
        mh.barrier("variants-ckpt-clear")
        if pid == 0:
            header = "".join(h + "\n" for h in vcf.headers).encode()
            merge_parts(out_path, pcount, header=header)
        mh.barrier("variants-merged")
    if dbg is not None:
        dbg.close()
    ckpt.done()
    return {"records": n_selected}
