"""Command-line interface.

`merfin-tpu` accepts the reference merfin's flag set (merfin.C:80-155)
so existing pipelines can switch by swapping the binary name:

    merfin-tpu -hist -sequence asm.fasta -readmers read.mkdb \
               -peak 106.7 -output out.hist

Databases are MKDB directories (see merfin_tpu/io/mkdb.py); `meryl print`
text dumps can be imported with `merfin-tpu import`.  The meryl-analog
database tools (count / print / statistics / histogram / intersect /
union-sum / subtract / divide-round) live under the same binary, like

    merfin-tpu count k=21 reads.fastq.gz output read.mkdb
"""

from __future__ import annotations

import os
import sys

from merfin_tpu.config import MerfinConfig, ensure_x64, setup_runtime

_U64MAX = 2**64 - 1

_DB_SUBCOMMANDS = {
    "count", "print", "statistics", "histogram", "intersect", "union-sum",
    "subtract", "divide-round", "import", "export",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _DB_SUBCOMMANDS:
        return db_tool_main(argv)
    return merfin_main(argv)


# ---------------- merfin-compatible path ----------------

def merfin_main(argv: list[str]) -> int:
    cfg = MerfinConfig()
    errs: list[str] = []

    i = 0
    def nextarg() -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise IndexError
        return argv[i]

    mode_flags = {
        "-filter": "filter", "-better": "better", "-strict": "strict",
        "-loose": "loose", "-polish": "polish", "-hist": "hist",
        "-dump": "dump", "-completeness": "completeness",
    }

    try:
        while i < len(argv):
            a = argv[i]
            if a == "-sequence":
                cfg.seq_name = nextarg()
            elif a == "-seqmers":
                cfg.seq_db_name = nextarg()
            elif a == "-readmers":
                cfg.read_db_name = nextarg()
            elif a == "-peak":
                cfg.peak = float(nextarg())
            elif a == "-prob":
                cfg.prob_table = nextarg()
            elif a == "-vcf":
                cfg.vcf_name = nextarg()
            elif a == "-output":
                cfg.out_name = nextarg()
            elif a == "-min":
                cfg.min_v = int(nextarg())
            elif a == "-max":
                cfg.max_v = int(nextarg())
            elif a == "-threads":
                cfg.threads = int(nextarg())
            elif a == "-memory":
                cfg.max_memory_gb = float(nextarg())
            elif a == "-nosplit":
                cfg.nosplit = True
            elif a == "-skipMissing":
                cfg.skip_missing = True
            elif a == "-comb":
                cfg.comb = int(nextarg())
            elif a == "-debug":
                cfg.debug = True
            elif a == "-resume":
                cfg.resume = True
            elif a == "-mesh":
                cfg.mesh = nextarg()
            elif a == "-devscore":
                cfg.devscore = True
            elif a == "-nodevscore":
                cfg.devscore = False
            elif a in mode_flags:
                if a == "-loose":
                    print("*EXPERIMENTAL* Running in -loose mode", file=sys.stderr)
                cfg.report_type = mode_flags[a]
            else:
                errs.append(f"Unknown option '{a}'.\n")
            i += 1
    except IndexError:
        errs.append(f"Option '{argv[-1]}' needs an argument.\n")

    # input validation (merfin.C:157-182)
    vcf_modes = ("filter", "polish", "better", "strict", "loose")
    if cfg.report_type != "completeness":
        if cfg.seq_name is None:
            errs.append("No input sequences (-sequence) supplied.\n")
        if cfg.out_name is None:
            errs.append("No output (-output) supplied.\n")
    if cfg.report_type in vcf_modes and cfg.vcf_name is None:
        errs.append("No variant call input (-vcf) supplied; mandatory for -filter or -polish.\n")
    if cfg.report_type != "filter" and cfg.peak == 0:
        errs.append("No haploid peak (-peak) supplied.\n")
    if cfg.report_type == "completeness" and cfg.seq_name is None and cfg.seq_db_name is None:
        errs.append("No sequence meryl database (-seqmers) nor sequence (-sequence) supplied.\n")
    if cfg.report_type is None:
        errs.append("No report type (-filter, -polish, -hist, -dump, -completeness) supplied.\n")
    if cfg.read_db_name is None:
        errs.append("No read meryl database (-readmers) supplied.\n")

    if errs:
        _usage()
        for e in errs:
            sys.stderr.write(e)
        return 1

    return run(cfg)


def _usage() -> None:
    # Full-parity help: same shape and content as the reference's usage
    # dump (merfin.C:185-356) — per-mode sections with required/optional
    # flags and output schemas — adapted where the backing store differs
    # (MKDB instead of meryl) and extended with this build's own flags.
    _VCF_OPTS = (
        "   Optional: -comb <N>    set the max N of combinations of variants to be evaluated (default: 15)\n"
        "             -nosplit     without this option combinations larger than N are split\n"
        "             -prob <file> use probabilities to adjust multiplicity to copy number (recommended)\n"
        "             -debug       output a debug log, into <output>.THREAD_ID.debug.gz\n"
        "\n")
    _POLISH_OUT = (
        "   Output: <output>.polish.vcf : variants chosen.\n"
        "     use bcftools view -Oz <output>.polish.vcf and bcftools consensus -H 1 -f <seq.fasta> to polish.\n"
        "     first ALT in heterozygous alleles are usually better supported by avg. |k*|.\n"
        "\n\n")
    sys.stderr.write(
        "usage: merfin-tpu <report-type>        \\\n"
        "         -sequence <seq.fasta>     \\\n"
        "         -readmers <read.mkdb>     \\\n"
        "         -peak     <haploid_peak>  \\\n"
        "         -prob     <lookup_table>  \\\n"
        "         -vcf      <input.vcf>     \\\n"
        "         -output   <output>        \n"
        "\n"
        "  Predict the kmer consequences of variant calls <input.vcf> given the consensus sequence <seq.fasta>\n"
        "  and lookup the k-mer multiplicity in the consensus sequence <seq.mkdb> and in the reads <read.mkdb>.\n"
        "\n"
        "  Input -sequence and -vcf files can be FASTA or FASTQ; uncompressed, gz, bz2 or xz compressed\n"
        "\n"
        "  Each readmers can be filtered by value.  More advanced filtering\n"
        "  requires a new database to be constructed using the db tools below.\n"
        "    -min     m     Ignore kmers with value below m\n"
        "    -max     m     Ignore kmers with value above m\n"
        "    -threads t     Multithreading for lookup table construction, dump and hist.\n"
        "\n"
        "  Memory usage can be limited, within reason, by sacrificing kmer lookup\n"
        "  speed.  If the lookup table requires more memory than allowed, the program\n"
        "  exits with an error.\n"
        "    -memory  m     Don't use more than m GB memory for loading mers\n"
        "\n"
        "  For k* based evaluation and polishing, -peak is required with optional -prob.\n"
        "    -peak    m     Required input to hard set copy 1 and infer multiplicity to copy number (recommended).\n"
        "    -prob    file  Optional input vector of probabilities. Adjust multiplicity to copy number\n"
        "                   in case both -prob and -peak are provided, -prob takes higher priority\n"
        "                   than -peak for multiplicity listed in the vector table.\n"
        "\n"
        "  By default, <seq.fasta>.mkdb will be generated unless -seqmers is provided.\n"
        "    -seqmers seq.mkdb  Optional input for pre-built sequence kmer db\n"
        "\n"
        "  Exactly one report type must be specified.\n"
        "\n\n"
        "  -filter\n"
        "   Filter variants within distance k and their combinations by missing k-mers.\n"
        "   Assumes the reference (-sequence) is from a different individual.\n"
        "   Required: -sequence, -readmers, -vcf, and -output\n"
        "   Optional: -comb <N>  set the max N of combinations of variants to be evaluated (default: 15)\n"
        "             -nosplit   without this option combinations larger than N are split\n"
        "             -debug     output a debug log, into <output>.THREAD_ID.debug.gz\n"
        "\n"
        "   Output: <output>.filter.vcf : variants chosen.\n"
        "\n\n"
        "  -polish\n"
        "   Score each variant, or variants within distance k and their combinations by k*.\n"
        "   Assumes the reference (-sequence) is from the same individual.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, -vcf, and -output\n"
        + _VCF_OPTS + _POLISH_OUT +
        "  -loose (least conservative)\n"
        "   Score each variant, or variants within distance k and their combinations without k*.\n"
        "   Assumes the reference (-sequence) is partially from the same individual.\n"
        "   Remove variants only when the num. missing (error) k-mers increase.\n"
        "   Neutral alternative paths that score equally to the reference path are included.\n"
        "   If multiple candidate paths tie, path with most ALT calls gets chosen.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, -vcf, and -output\n"
        + _VCF_OPTS + _POLISH_OUT +
        "  -strict (most conservative)\n"
        "   Score each variant, or variants within distance k and their combinations without k*.\n"
        "   Assumes the reference (-sequence) is partially from the same individual.\n"
        "   Include variants only when the num. missing (error) k-mers decrease.\n"
        "   Neutral alternative paths that score equally to the reference path are excluded.\n"
        "   If multiple candidate paths tie, path with least ALT calls gets chosen.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, -vcf, and -output\n"
        + _VCF_OPTS + _POLISH_OUT +
        "  -better (legacy, nearly identical to -polish without k*)\n"
        "   Score each variant, or variants within distance k and their combinations without k*.\n"
        "   Assumes the reference (-sequence) is partially from the same individual.\n"
        "   Include variants only when the num. missing (error) k-mers decrease.\n"
        "   Neutral alternative paths that score equally to the reference path are excluded.\n"
        "   If multiple candidate paths tie, the longest path is chosen.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, -vcf, and -output\n"
        + _VCF_OPTS + _POLISH_OUT +
        "  -hist\n"
        "   Generate a 0-centered k* histogram for sequences in <input.fasta>.\n"
        "     Positive k* values are expected collapsed copies.\n"
        "     Negative k* values are expected expanded  copies.\n"
        "     Closer to 0 means the expected and found k-mers are well balanced, 1:1.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, and -output.\n"
        "   Optional: -prob <file>  use probabilities to adjust multiplicity to copy number (recommended)\n"
        "\n"
        "   Output: k* <tab> frequency\n"
        "           Reports QV at the end, in stderr.\n"
        "\n\n"
        "  -dump\n"
        "   Dump readK, asmK, and k* per bases (k-mers) in <input.fasta>.\n"
        "\n"
        "   Required: -sequence, -readmers, -peak, and -output\n"
        "   Optional: -skipMissing  skip the missing kmer sites to be printed\n"
        "             -prob <file>  use probabilities to adjust multiplicity to copy number (recommended)\n"
        "\n"
        "   Output: seqName <tab> seqPos <tab> readK <tab> asmK <tab> k*\n"
        "      seqName    - name of the sequence this kmer is from\n"
        "      seqPos     - start position (0-based) of the kmer in the sequence\n"
        "      readK      - normalized read copies (read multiplicity / peak)\n"
        "      asmK       - assembly copies as found in <seq.mkdb>\n"
        "      k*         - 0-centered k* value\n"
        "\n\n"
        "  -completeness\n"
        "   Compute kmer completeness using expected copy numbers for all kmers.\n"
        "\n"
        "   Required: -seqmers (or -sequence), -readmers, -peak\n"
        "   Optional: -prob <file>  use probabilities to adjust multiplicity to copy number (recommended)\n"
        "\n"
        "   Output: total kmers in reads, number of kmers under the expected copy number, and completeness\n"
        "\n\n"
        "  Optional output from -debug in -filter and -polish:\n"
        "   <output>.THREAD_ID.debug.gz : some useful info for debugging.\n"
        "      seqName <tab> varMerStart <tab> varMerEnd <tab> varMerSeq <tab> score <tab> path\n"
        "      varMerID                - unique numbering, starting from 0\n"
        "      varMerRange             - seqName:start-end. position (0-based) of the variant (s),\n"
        "                                including sequences upstream and downstream of k-1 bp\n"
        "      varMerSeq               - combination of variant sequence to evalute\n"
        "      numMissings             - total number of missing kmers\n"
        "      min k*                  - minimum of all |k*| for non-missing kmers. -1 when all kmers are missing.\n"
        "      max k*                  - maximum of all |k*| for non-missing kmers. -1 when all kmers are missing.\n"
        "      median k*               - median  of all |k*| for non-missing kmers. -1 when all kmers are missing.\n"
        "      avg k*                  - average of all |k*| for non-missing kmers. -1 when all kmers are missing.\n"
        "      avg ref-alt k*          - difference between reference and alternate average k*.\n"
        "      delta kmer multiplicity - cumulative sum of kmer multiplicity variation.\n"
        "                                positive values imply recovered kmers, while\n"
        "                                negative values imply overrepresented kmers introduced.\n"
        "      record                  - vcf record with <tab> replaced to <space>.\n"
        "                                only non-reference alleles are printed with GT being 1/1.\n"
        "\n\n"
        "  Extensions (all optional):\n"
        "    -mesh DxT        shard the lookup tables over a DxT device mesh (all report types)\n"
        "    -resume          checkpointed restart at the sequence boundary\n"
        "    -devscore / -nodevscore    fused on-device variant scoring (auto: on wherever\n"
        "                     it is provably byte-identical — all numM-only modes, and -polish\n"
        "                     without a -prob table via the integer fast path; off for -debug\n"
        "                     and -polish with -prob, which compare host doubles)\n"
        "  Multi-host: set MERFIN_NUM_PROCESSES, MERFIN_PROCESS_ID and MERFIN_COORDINATOR\n"
        "  (host:port) on every host; sequences/DB slices stripe across processes and\n"
        "  rank 0 writes the merged outputs.\n"
        "\n"
        "  Databases are MKDB directories (build with: merfin-tpu count k=21 in.fq output db;\n"
        "  add memory=GB to bound the counter with disk spill);\n"
        "  import a meryl db via its text dump: merfin-tpu import dump.txt output=db.\n"
        "  Other db tools: print statistics histogram intersect union-sum subtract divide-round export.\n"
        "\n\n"
    )


def _db_max(db) -> int:
    import numpy as np

    return int(np.asarray(db.vals).max()) if db.distinct else 1


def _device_hbm_gb() -> float | None:
    """Per-device accelerator memory in GB; None when unknown (CPU)."""
    import jax

    try:
        dev = jax.devices()[0]
        if dev.platform == "cpu":
            return None
        stats = dev.memory_stats()
        if stats and "bytes_limit" in stats:
            return stats["bytes_limit"] / 1024**3
    except Exception:
        return None
    return None


def run(cfg: MerfinConfig) -> int:
    """Load DBs and dispatch the report — main() (merfin.C:358-430)."""
    setup_runtime()

    from merfin_tpu.io.mkdb import KmerDB, is_mkdb
    from merfin_tpu.io.prob import load_prob_table
    from merfin_tpu.io.fasta import SeqFile
    from merfin_tpu.table.lookup import build_lookup

    log = sys.stderr

    # Multi-host launch (MERFIN_NUM_PROCESSES / MERFIN_PROCESS_ID /
    # MERFIN_COORDINATOR): each process takes a sequence (or DB-slice)
    # stripe; accumulators merge over collectives; rank 0 writes outputs.
    from merfin_tpu.parallel import multihost as mh

    # Multi-host runs support the full flag set: -debug writes per-rank
    # gz files (the reference's per-thread debug split) and -resume
    # keeps per-rank checkpoints (modes/variants.py, utils/checkpoint.py).
    multi = mh.maybe_init_from_env(log=log)

    prob = load_prob_table(cfg.prob_table) if cfg.prob_table else None

    # Build the sequence DB if not provided (merfin-globals.C:166-189).
    if cfg.report_type != "completeness" or cfg.seq_db_name is None:
        if cfg.seq_db_name is None:
            if cfg.read_db_name is None or not is_mkdb(cfg.read_db_name):
                print(f"ERROR: read database '{cfg.read_db_name}' is not an MKDB "
                      f"directory (build or import it first).", file=log)
                return 1
            k = KmerDB(cfg.read_db_name).k
            base = os.path.basename(cfg.seq_name)
            cfg.seq_db_name = f"{base}.meryl"
            print(f"-- No -seqmer given. Build sequence db as '{cfg.seq_db_name}'.",
                  file=log)
            from merfin_tpu.count.counter import count_files

            # multi-host aware: ranks stripe the input blocks and rank 0
            # merges the database (count_files barriers internally)
            count_files([cfg.seq_name], k, cfg.seq_db_name, log=log)

    read_db = KmerDB(cfg.read_db_name)
    asm_db = KmerDB(cfg.seq_db_name)
    if read_db.k != asm_db.k:
        print(f"ERROR: k mismatch: read db k={read_db.k}, seq db k={asm_db.k}",
              file=log)
        return 1
    k = read_db.k

    # memory estimate + fail-fast (merfin-globals.C:134-153)
    req = read_db.estimate_memory_gb() + asm_db.estimate_memory_gb()
    print(f"-- Estimating required space for loading '{cfg.read_db_name}'", file=log)
    print(f"-- Estimating required space for loading '{cfg.seq_db_name}'", file=log)
    print("--", file=log)
    print(f"-- Memory needed: {req:.3f} GB", file=log)
    print(f"-- Memory limit:  {cfg.max_memory_gb:.3f} GB", file=log)
    print("--", file=log)
    if req > cfg.max_memory_gb:
        print("\nNot enough memory to load databases.  Increase -memory.\n", file=log)
        return 1

    # Mesh: every report type rides it (the reference parallelizes every
    # mode: sweatShop merfin.C:366-413, OpenMP merfin-completeness.C:65).
    mesh = None
    t_shards = 1
    if cfg.mesh:
        import jax
        import numpy as np
        from jax.sharding import Mesh

        try:
            d, t = (int(x) for x in cfg.mesh.lower().split("x"))
        except ValueError:
            print(f"ERROR: -mesh '{cfg.mesh}' is not DxT (e.g. 2x4).", file=log)
            return 1
        devs = jax.devices()
        if len(devs) < d * t:
            print(f"ERROR: -mesh {d}x{t} needs {d * t} devices; "
                  f"{len(devs)} available.", file=log)
            return 1
        if multi and d * t != len(devs):
            # a partial mesh under a multi-host launch would leave some
            # processes driving only other hosts' devices
            hint = (f"{len(devs) // t}x{t}" if len(devs) % t == 0
                    else f"1x{len(devs)}")
            print(f"ERROR: -mesh {d}x{t} must use all {len(devs)} devices "
                  f"of the multi-host slice (e.g. -mesh {hint}).", file=log)
            return 1
        mesh = Mesh(np.asarray(devs[: d * t]).reshape(d, t), ("d", "t"))
        t_shards = t
        print(f"-- Sharding tables over a {d}x{t} device mesh.", file=log)

    # HBM fail-fast: tables must fit the accelerator memory they will be
    # device_put into — whole tables on one chip, or 1/T per chip when
    # sharded over the "t" axis.  merfin-globals.C:148-153 semantics
    # against device (not host) capacity; error before a device OOM.
    hbm_gb = _device_hbm_gb()
    if hbm_gb is not None and cfg.report_type != "completeness":
        per_dev = req / t_shards
        if per_dev > 0.92 * hbm_gb:    # headroom for batches + compiled code
            print(f"\nLookup tables need {per_dev:.1f} GB per device but "
                  f"device HBM is {hbm_gb:.1f} GB.", file=log)
            if mesh is None:
                import jax

                n = len(jax.devices())
                if n > 1:
                    t_need = max(2, int(per_dev / (0.92 * hbm_gb)) + 1)
                    print(f"Shard the tables over the device mesh: "
                          f"-mesh 1x{min(t_need, n)} (up to {n} devices "
                          f"available).\n", file=log)
            else:
                print("Increase the -mesh table axis (DxT with larger T).\n",
                      file=log)
            return 1

    if cfg.report_type == "completeness":
        from merfin_tpu.modes.completeness import run_completeness

        print("-- Compute completeness.", file=log)
        run_completeness(read_db, asm_db, cfg.peak, prob_table=prob, log=log,
                         mesh=mesh)
        print("Bye!", file=log)
        return 0

    if mesh is not None:
        from merfin_tpu.parallel.sharded import ShardedLookup

        print(f"-- Loading kmers from '{cfg.read_db_name}' into sharded table.",
              file=log)
        read_sharded = ShardedLookup.build(read_db, mesh, min_v=cfg.min_v,
                                           max_v=cfg.max_v)
        print(f"-- Loading kmers from '{cfg.seq_db_name}' into sharded table.",
              file=log)
        asm_sharded = ShardedLookup.build(asm_db, mesh)
    else:
        print(f"-- Loading kmers from '{cfg.read_db_name}' into lookup table.", file=log)
        read_lookup = build_lookup(read_db, min_v=cfg.min_v, max_v=cfg.max_v)
        print(f"-- Loading kmers from '{cfg.seq_db_name}' into lookup table.", file=log)
        asm_lookup = build_lookup(asm_db)

    seq_file = SeqFile(cfg.seq_name)

    def make_engine():
        if mesh is not None:
            from merfin_tpu.parallel.engine import ShardedKstarEngine

            return ShardedKstarEngine(
                mesh, read_sharded, asm_sharded, k, cfg.peak, prob_table=prob,
                max_value=_db_max(read_db), exact_max=True,
                asm_max_value=_db_max(asm_db))
        from merfin_tpu.modes.engine import KstarEngine

        return KstarEngine(read_lookup, asm_lookup, k, cfg.peak, prob_table=prob,
                           max_value=_db_max(read_db), exact_max=True,
                           asm_max_value=_db_max(asm_db))

    if cfg.report_type == "hist":
        from merfin_tpu.modes.hist import run_hist

        print(f"-- Generate histogram of the k* metric to '{cfg.out_name}'.", file=log)
        run_hist(make_engine(), seq_file, cfg.out_name, log=log, resume=cfg.resume)

    elif cfg.report_type == "dump":
        from merfin_tpu.modes.dump import run_dump

        print(f"-- Dump per-base k* metric to '{cfg.out_name}'.", file=log)
        run_dump(make_engine(), seq_file, cfg.out_name, skip_missing=cfg.skip_missing,
                 log=log, resume=cfg.resume)

    else:
        from merfin_tpu.io.vcf import VcfFile
        from merfin_tpu.modes.variants import run_variants

        print(f"-- Opening vcf file '{cfg.vcf_name}'.", file=log)
        vcf = VcfFile(cfg.vcf_name, log=log)
        print(f"Merge variants within {k}-mer bases, splitting combinations "
              f"greater than {cfg.comb}.", file=log)
        vcf.merge_clusters(k, cfg.comb, cfg.nosplit, log=log)

        print("-- Generate variant mers and score them.", file=log)
        scorer = None
        if mesh is not None:
            rlookup, alookup = read_sharded.lookup_np, asm_sharded.lookup_np
        else:
            rlookup, alookup = read_lookup.lookup_np, asm_lookup.lookup_np
        # Fused device scoring: default for the numM-only modes (their
        # selectors are provably byte-identical under it — see
        # variants/device_score.py docstring).  -polish also defaults
        # to the device when the INTEGER fast path applies (no -prob
        # table; ValueMap.int_scorer_ok re-checked below): its totdk
        # sums are then pure integer arithmetic, EXACTLY equal to the
        # host scorer's — r5 heavy bench asserts byte-identical VCFs at
        # an 18-20x device-vs-host rate.  With a -prob table or -debug
        # the host-exact scorer stays the default.
        use_dev = cfg.devscore
        if use_dev is None:
            use_dev = not cfg.debug and (
                cfg.report_type != "polish" or prob is None)
        elif use_dev and cfg.debug:
            print("ERROR: -debug needs per-window K* stats; it cannot run "
                  "with -devscore.", file=log)
            return 1
        if use_dev:
            print("-- Using fused device scoring (-devscore).", file=log)
            if mesh is not None:
                from merfin_tpu.variants.device_score import ShardedScorer

                scorer = ShardedScorer(mesh, read_sharded, asm_sharded, k,
                                       cfg.peak, prob,
                                       max_value=_db_max(read_db),
                                       exact_max=True)
            else:
                from merfin_tpu.variants.device_score import DeviceScorer

                scorer = DeviceScorer(read_lookup, asm_lookup, k, cfg.peak,
                                      prob, max_value=_db_max(read_db),
                                      exact_max=True)
            if (cfg.report_type == "polish" and cfg.devscore is None
                    and not scorer.value_map.int_scorer_ok()):
                # auto-selected polish devscore but the integer fast
                # path doesn't hold (e.g. huge readK): keep host-exact
                print("-- Device scoring lacks the integer fast path "
                      "here; using the host scorer for -polish.", file=log)
                scorer = None
        run_variants(
            cfg.report_type, seq_file, vcf, k,
            rlookup, alookup,
            cfg.peak, prob, cfg.out_name, comb=cfg.comb, debug=cfg.debug, log=log,
            resume=cfg.resume, threads=cfg.threads,
            spans=mesh is not None and multi, scorer=scorer,
        )

    print("Bye!", file=log)
    return 0


# ---------------- database tools (meryl analog) ----------------

def db_tool_main(argv: list[str]) -> int:
    setup_runtime()   # x64 + persistent compile cache
    from merfin_tpu.io.mkdb import KmerDB
    from merfin_tpu.io import meryl_text
    from merfin_tpu.count import algebra
    from merfin_tpu.parallel.multihost import maybe_init_from_env

    # `count` stripes input blocks across a multi-host launch
    maybe_init_from_env(log=sys.stderr)

    cmd = argv[0]
    args = argv[1:]

    def split_kv(args):
        opts, pos = {}, []
        for a in args:
            if "=" in a and not os.path.exists(a):
                k, v = a.split("=", 1)
                opts[k] = v
            else:
                pos.append(a)
        return opts, pos

    opts, pos = split_kv(args)
    out = None
    if "output" in opts:
        out = opts["output"]
    elif "output" in pos:
        j = pos.index("output")
        out = pos[j + 1]
        pos = pos[:j] + pos[j + 2:]

    mem = float(opts["memory"]) if "memory" in opts else None

    if cmd == "count":
        from merfin_tpu.count.counter import count_files

        k = int(opts.get("k", 21))
        assert out, "count: need output <db>"
        count_files(pos, k, out, memory_gb=mem)
        return 0

    if cmd == "import":
        assert out and len(pos) == 1, "import: <text> output <db>"
        meryl_text.import_text(pos[0], out, memory_gb=mem)
        return 0

    if cmd in ("print", "export"):
        db = KmerDB(pos[0])
        if out:
            meryl_text.export_text(db, out)
        else:
            for i in range(db.distinct):
                sys.stdout.write(
                    f"{meryl_text.decode_kmer(int(db.keys[i]), db.k)}\t{int(db.vals[i])}\n")
        return 0

    if cmd == "statistics":
        st = algebra.statistics(KmerDB(pos[0]))
        sys.stdout.write(
            f"Number of {st['k']}-mers that are:\n"
            f"    unique   {st['unique']:>12}\n"
            f"    distinct {st['distinct']:>12}\n"
            f"    present  {st['present']:>12}\n")
        return 0

    if cmd == "histogram":
        for v, c in sorted(algebra.histogram(KmerDB(pos[0])).items()):
            sys.stdout.write(f"{v}\t{c}\n")
        return 0

    if cmd == "intersect":
        assert out and len(pos) >= 2
        algebra.intersect(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "union-sum":
        assert out and len(pos) >= 1
        algebra.union_sum(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "subtract":
        assert out and len(pos) >= 2
        algebra.subtract(out, *[KmerDB(p) for p in pos])
        return 0

    if cmd == "divide-round":
        assert out and len(pos) == 2
        d = float(pos[0])
        algebra.divide_round(out, KmerDB(pos[1]), d)
        return 0

    sys.stderr.write(f"unknown db tool '{cmd}'\n")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
