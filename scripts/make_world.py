#!/usr/bin/env python3
"""Generate a synthetic evaluation world: true genome, an assembly with
known substitution errors, a read set, MKDB databases, and a candidate
VCF (true corrections as multiallelic records + spurious calls).

chip_smoke.py's scale phase runs on such a world: -polish must select
exactly the true corrections, and accelerator and CPU outputs must match.
Count the databases with `merfin-tpu count` (the script prints how).

Usage:
  make_world.py <outdir> [--length 5000000] [--errors 200] [--coverage 30]
                [--k 21] [--seed 0] [--read-error 0.001]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--length", type=int, default=5_000_000)
    ap.add_argument("--errors", type=int, default=200)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--read-error", type=float, default=0.001)
    ap.add_argument("--spurious", type=int, default=100)
    args = ap.parse_args()

    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    alt_of = {65: 67, 67: 71, 71: 84, 84: 65}  # A>C>G>T>A

    genome = bases[rng.integers(0, 4, size=args.length)]
    asm = genome.copy()
    err_pos = np.sort(rng.choice(args.length - 2 * args.k, size=args.errors,
                                 replace=False) + args.k)
    for p in err_pos:
        asm[p] = alt_of[asm[p]]

    asm_s = asm.tobytes().decode()
    with open(f"{args.outdir}/asm.fasta", "w") as f:
        f.write(">sim\n")
        for i in range(0, args.length, 80):
            f.write(asm_s[i : i + 80] + "\n")

    n_reads = args.length * args.coverage // args.read_len
    starts = rng.integers(0, args.length - args.read_len, size=n_reads)
    rl = args.read_len
    alt_lut = np.arange(256, dtype=np.uint8)
    for a, b in alt_of.items():
        alt_lut[a] = b
    with open(f"{args.outdir}/reads.fasta", "wb") as f:
        batch = 200_000
        for lo in range(0, n_reads, batch):
            st = starts[lo : lo + batch]
            reads = genome[st[:, None] + np.arange(rl)[None, :]].copy()
            errs = rng.random(reads.shape) < args.read_error
            reads[errs] = alt_lut[reads[errs]]
            headers = np.char.add(
                np.char.add(">r", np.arange(lo, lo + st.size).astype(str)), "\n")
            block = bytearray()
            rb = reads.tobytes()
            for i, h in enumerate(headers):
                block += h.encode()
                block += rb[i * rl : (i + 1) * rl]
                block += b"\n"
            f.write(block)

    # candidate VCF: every true locus gets all three alternative bases
    # (polish must pick the right one) + spurious heterozygous calls
    # elsewhere, which keep the REF allele (0/1: alleles come from the
    # GT field).  They alternate between substitutions to the base a
    # read error spells there (alt_of, so some have partial read
    # support) and 2-base insertions, which no read spells.
    rows = []
    err_set = set(int(x) for x in err_pos)
    for p in err_pos:
        ref = asm_s[p]
        alts = ",".join(b for b in "ACGT" if b != ref)
        rows.append((int(p) + 1, ref, alts, 50.0, "1/2/3"))
    clean = rng.integers(args.k, args.length - args.k, size=args.spurious)
    for i, p in enumerate(clean):
        p = int(p)
        if p in err_set:
            continue
        ref = asm_s[p]
        if i % 2 == 0:
            alt = chr(alt_of[ord(ref)])
        else:
            alt = ref + "".join("ACGT"[int(x)]
                                for x in rng.integers(0, 4, size=2))
        rows.append((p + 1, ref, alt, 9.9, "0/1"))
    rows.sort()
    with open(f"{args.outdir}/cand.vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=sim>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for pos, ref, alts, q, gt in rows:
            f.write(f"sim\t{pos}\t.\t{ref}\t{alts}\t{q}\tPASS\t.\tGT\t{gt}\n")

    np.save(f"{args.outdir}/err_pos.npy", err_pos)
    np.save(f"{args.outdir}/true_genome_codes.npy", genome)

    d = args.outdir
    print(f"world ready in {d}: {args.errors} errors, {n_reads} reads, "
          f"k={args.k}; suggested -peak: "
          f"{args.coverage * (args.read_len - args.k + 1) / args.read_len:.1f}"
          f"\ncount it with:\n"
          f"  bin/merfin-tpu count k={args.k} {d}/reads.fasta output={d}/read.mkdb\n"
          f"  bin/merfin-tpu count k={args.k} {d}/asm.fasta output={d}/asm.mkdb")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
