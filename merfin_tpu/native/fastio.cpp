// Native host data plane for merfin_tpu.
//
// The reference keeps its sequence IO and output formatting in C++
// (dnaSeqFile/compressedFileWriter, utility submodule; consumed at
// merfin.C:38 and merfin-dump.C:92).  This library provides the same
// host-side speed for the JAX engine:
//   * FASTA/FASTQ parsing + 2-bit base encoding into uint8 code arrays
//     (A=0 C=1 G=2 T=3, other=4) in one pass,
//   * %.2f dump-row formatting (merfin-dump.C:92 format, zero-row skip).
//
// Exposed as a plain C ABI for ctypes.  Build: merfin_tpu/native/Makefile.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

extern "C" {

static uint8_t CODE[256];

static void init_codes() {
  static bool done = false;
  if (done) return;
  memset(CODE, 4, sizeof(CODE));
  CODE[(int)'A'] = 0; CODE[(int)'a'] = 0;
  CODE[(int)'C'] = 1; CODE[(int)'c'] = 1;
  CODE[(int)'G'] = 2; CODE[(int)'g'] = 2;
  CODE[(int)'T'] = 3; CODE[(int)'t'] = 3;
  done = true;
}

// Parse FASTA/FASTQ bytes into encoded base codes.
//
// data/len   : whole (decompressed) file contents.
// out_codes  : caller buffer, capacity >= len; receives concatenated codes.
// out_offsets: caller int64 buffer, capacity max_seqs+1; receives
//              [start,end) offsets per sequence (offsets[0] == 0).
// Returns the sequence count, -1 on format error, -2 if > max_seqs.
int64_t mt_parse_seqs(const uint8_t* data, int64_t len,
                      uint8_t* out_codes, int64_t* out_offsets,
                      int64_t max_seqs) {
  init_codes();
  if (len == 0) return 0;
  const bool fastq = data[0] == '@';
  if (!fastq && data[0] != '>') return -1;

  int64_t nseq = 0, w = 0, i = 0;
  out_offsets[0] = 0;

  while (i < len) {
    const char h = (char)data[i];
    if (h == '\n' || h == '\r') { i++; continue; }
    if ((!fastq && h != '>') || (fastq && h != '@')) return -1;
    if (nseq >= max_seqs) return -2;
    while (i < len && data[i] != '\n') i++;   // skip header line
    i++;

    int64_t seq_start = w;
    if (!fastq) {
      while (i < len && data[i] != '>') {
        const uint8_t c = data[i++];
        if (c != '\n' && c != '\r') out_codes[w++] = CODE[c];
      }
    } else {
      while (i < len && data[i] != '\n') {    // single sequence line
        const uint8_t c = data[i++];
        if (c != '\r') out_codes[w++] = CODE[c];
      }
      i++;
      while (i < len && data[i] != '\n') i++; // '+' line
      i++;
      int64_t q = 0, need = w - seq_start;
      while (i < len && q < need) {           // quality chars
        const uint8_t c = data[i++];
        if (c != '\n' && c != '\r') q++;
      }
      while (i < len && (data[i] == '\n' || data[i] == '\r')) i++;
    }
    nseq++;
    out_offsets[nseq] = w;
  }
  return nseq;
}

// Extract NUL-separated idents (first word of each header) in order.
// Returns the name count, or -1 when out capacity is insufficient.
int64_t mt_parse_names(const uint8_t* data, int64_t len,
                       char* out, int64_t cap) {
  if (len == 0) return 0;
  const bool fastq = data[0] == '@';
  int64_t n = 0, w = 0, i = 0;

  while (i < len) {
    const char h = (char)data[i];
    if (h == '\n' || h == '\r') { i++; continue; }
    const bool is_header = (!fastq && h == '>') || (fastq && h == '@');
    if (is_header) {
      i++;
      while (i < len && data[i] != '\n' && data[i] != ' ' &&
             data[i] != '\t' && data[i] != '\r') {
        if (w + 2 >= cap) return -1;
        out[w++] = (char)data[i++];
      }
      out[w++] = '\0';
      n++;
      while (i < len && data[i] != '\n') i++;
      i++;
      if (!fastq) {
        while (i < len && data[i] != '>') i++;        // skip sequence
      } else {
        while (i < len && data[i] != '\n') i++;       // sequence line
        i++;
        while (i < len && data[i] != '\n') i++;       // '+' line
        i++;
        while (i < len && data[i] != '\n') i++;       // quality line
        i++;
      }
    } else {
      return -1;
    }
  }
  return n;
}

// Dump-row formatting (merfin-dump.C:87-93): "ident\tpos\t%.2f\t%.2f\t%.2f\n"
// for every position where any value is nonzero.  Returns bytes written,
// or -1 if out_cap is too small.
int64_t mt_format_dump_rows(const char* ident, int64_t start,
                            const double* read_k, const double* asm_k,
                            const double* km, int64_t n,
                            char* out, int64_t out_cap) {
  int64_t w = 0;
  const int64_t ident_len = (int64_t)strlen(ident);
  for (int64_t i = 0; i < n; i++) {
    if (read_k[i] == 0.0 && asm_k[i] == 0.0 && km[i] == 0.0) continue;
    if (w + ident_len + 96 > out_cap) return -1;
    memcpy(out + w, ident, ident_len);
    w += ident_len;
    w += snprintf(out + w, (size_t)(out_cap - w), "\t%lld\t%.2f\t%.2f\t%.2f\n",
                  (long long)(start + i), read_k[i], asm_k[i], km[i]);
  }
  return w;
}

// Rolling k-mer extraction over a 2-bit code array: single pass,
// O(1) state per position (the kmerIterator contract, consumed at
// merfin-dump.C:44-61).  The numpy equivalent does 2k full-array passes
// with uint64 temporaries; this is the host hot path for variant-window
// scoring, so it matters.
//
// out_fmer[i]  = big-endian 2-bit pack of codes[i..i+k)
// out_rmer[i]  = reverse complement pack
// out_valid[i] = 1 iff the window has no code >= 4
// n_out = len - k + 1 (caller allocates; returns n_out, or 0 if len < k).
int64_t mt_kmers_from_codes(const uint8_t* codes, int64_t len, int64_t k,
                            uint64_t* out_fmer, uint64_t* out_rmer,
                            uint8_t* out_valid) {
  const int64_t n = len - k + 1;
  if (n <= 0) return 0;
  const uint64_t fmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int rshift = 2 * (int)(k - 1);
  uint64_t fmer = 0, rmer = 0;
  int64_t last_bad = -1;   // most recent invalid position
  for (int64_t i = 0; i < len; i++) {
    const uint64_t c = codes[i];
    const uint64_t cc = (c < 4) ? c : 0;
    if (c >= 4) last_bad = i;
    fmer = ((fmer << 2) | cc) & fmask;
    rmer = (rmer >> 2) | ((3ULL - cc) << rshift);
    const int64_t w = i - k + 1;   // window ending at i starts at w
    if (w >= 0) {
      out_fmer[w] = fmer;
      out_rmer[w] = rmer;
      out_valid[w] = (uint8_t)(last_bad < w);
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Streaming FASTA/FASTQ parser.
//
// The reference never materializes a whole input file: dnaSeqFile streams
// one sequence at a time (merfin.C:30-53).  This parser goes further and
// streams fixed-size byte windows with O(1) carried state, so a 100+ GB
// FASTQ.gz runs in bounded memory.  Each call parses one window and emits
// "pieces": contiguous 2-bit code runs, one per (record x window) overlap.
// A record larger than a window spans several pieces; piece_new[i] == 1
// iff piece i begins a new record (whose ident was appended to `names`).
//
// Tolerates multi-line FASTQ sequence and quality lines, CRLF, blank
// lines, and truncated trailing records (bases kept) — the dnaSeqFile
// tolerance contract (merfin.C:38).

enum {
  PH_START = 0,     // expecting a record header ('>' / '@')
  PH_HDR_NAME = 1,  // collecting ident (first word of header)
  PH_HDR_REST = 2,  // skipping rest of header line
  PH_SEQ = 3,       // sequence lines (FASTA until '>', FASTQ until '+')
  PH_PLUS = 4,      // FASTQ '+' line
  PH_QUAL = 5,      // FASTQ quality chars (counted, multi-line)
};

typedef struct {
  int32_t phase;
  int32_t fastq;         // -1 unknown yet, 0 FASTA, 1 FASTQ
  int32_t piece_is_new;  // current record has not emitted a piece yet
  int32_t name_len;
  int32_t at_line_start;
  int32_t _pad;
  int64_t seq_len;       // record bases so far (across windows)
  int64_t qual_seen;     // record quality chars so far
  char name[1024];
} mt_stream_state;

int64_t mt_stream_state_size() { return (int64_t)sizeof(mt_stream_state); }

void mt_stream_init(mt_stream_state* st) {
  memset(st, 0, sizeof(*st));
  st->phase = PH_START;
  st->fastq = -1;
  st->at_line_start = 1;
}

// Returns the piece count; -1 = not FASTA/FASTQ, -2 = capacity exceeded.
// out_codes needs capacity >= len; piece_off capacity max_pieces+1;
// names receives NUL-terminated idents for new pieces (bytes written to
// *name_bytes).
int64_t mt_stream_parse(const uint8_t* data, int64_t len, int32_t is_final,
                        mt_stream_state* st, uint8_t* out_codes,
                        int64_t* piece_off, uint8_t* piece_new,
                        int64_t max_pieces, char* names, int64_t name_cap,
                        int64_t* name_bytes) {
  init_codes();
  int64_t w = 0, np = 0, nw = 0, i = 0;
  piece_off[0] = 0;
  // resuming inside a record means a piece is open
  int in_piece = (st->phase == PH_SEQ || st->phase == PH_PLUS ||
                  st->phase == PH_QUAL);

#define CLOSE_PIECE()                                         \
  do {                                                        \
    if (np >= max_pieces) return -2;                          \
    piece_new[np] = (uint8_t)st->piece_is_new;                \
    if (st->piece_is_new) {                                   \
      if (nw + st->name_len + 1 > name_cap) return -2;        \
      memcpy(names + nw, st->name, (size_t)st->name_len);     \
      nw += st->name_len;                                     \
      names[nw++] = '\0';                                     \
    }                                                         \
    st->piece_is_new = 0;                                     \
    np++;                                                     \
    piece_off[np] = w;                                        \
    in_piece = 0;                                             \
  } while (0)

#define OPEN_RECORD()        \
  do {                       \
    st->piece_is_new = 1;    \
    st->seq_len = 0;         \
    st->qual_seen = 0;       \
    in_piece = 1;            \
  } while (0)

  while (i < len) {
    const uint8_t c = data[i];
    switch (st->phase) {
      case PH_START:
        if (c == '\n' || c == '\r' || c == ' ' || c == '\t') {
          i++;
          break;
        }
        if (st->fastq < 0) {
          if (c == '>') st->fastq = 0;
          else if (c == '@') st->fastq = 1;
          else return -1;
        } else if ((st->fastq == 0 && c != '>') ||
                   (st->fastq == 1 && c != '@')) {
          return -1;
        }
        st->phase = PH_HDR_NAME;
        st->name_len = 0;
        i++;
        break;

      case PH_HDR_NAME:
        if (c == '\n') {
          st->phase = PH_SEQ;
          st->at_line_start = 1;
          OPEN_RECORD();
        } else if (c == ' ' || c == '\t' || c == '\r') {
          st->phase = PH_HDR_REST;
        } else if (st->name_len < (int32_t)sizeof(st->name) - 1) {
          st->name[st->name_len++] = (char)c;
        }
        i++;
        break;

      case PH_HDR_REST:
        if (c == '\n') {
          st->phase = PH_SEQ;
          st->at_line_start = 1;
          OPEN_RECORD();
        }
        i++;
        break;

      case PH_SEQ:
        if (st->at_line_start && st->fastq == 0 && c == '>') {
          CLOSE_PIECE();              // FASTA record ends at next header
          st->phase = PH_HDR_NAME;
          st->name_len = 0;
          st->at_line_start = 0;
          i++;
          break;
        }
        if (st->at_line_start && st->fastq == 1 && c == '+') {
          st->phase = PH_PLUS;
          i++;
          break;
        }
        if (c == '\n') {
          st->at_line_start = 1;
          i++;
        } else if (c == '\r' || c == ' ' || c == '\t') {
          i++;
        } else {
          out_codes[w++] = CODE[c];
          st->seq_len++;
          st->at_line_start = 0;
          i++;
        }
        break;

      case PH_PLUS:
        if (c == '\n') {
          st->phase = PH_QUAL;
          // a record with zero bases has zero quality chars: done now
          if (st->qual_seen >= st->seq_len) {
            CLOSE_PIECE();
            st->phase = PH_START;
            st->at_line_start = 1;
          }
        }
        i++;
        break;

      case PH_QUAL:
        if (c == '\n' || c == '\r') {
          i++;
        } else {
          st->qual_seen++;
          i++;
          if (st->qual_seen >= st->seq_len) {
            CLOSE_PIECE();              // FASTQ record complete
            st->phase = PH_START;
            st->at_line_start = 1;
          }
        }
        break;
    }
  }

  if (is_final &&
      (st->phase == PH_HDR_NAME || st->phase == PH_HDR_REST)) {
    // truncated trailing header: emit it as an empty record
    OPEN_RECORD();
  }
  if (in_piece && (w > piece_off[np] || st->piece_is_new)) {
    CLOSE_PIECE();                      // window (or stream) ends mid-record
  }

#undef CLOSE_PIECE
#undef OPEN_RECORD
  *name_bytes = nw;
  return np;
}


// Assemble candidate-path byte streams from a piece table and encode
// to 2-bit codes in one pass, hashing each path's RAW bytes (the
// first-seen string-dedup screen, varMer.C:38-45).
//
// combined   : template bytes ++ allele/separator pool bytes.
// src/len    : int32 piece table, row-major [P, n_p] (src indexes
//              combined; zero-length pieces allowed).
// w1/w2      : uint32 position weights (length >= longest path).
// out_codes  : caller buffer, capacity >= total bytes; 2-bit codes
//              (A=0 C=1 G=2 T=3, other=4).
// out_hash   : uint64 [P]; (h1 << 32) | h2 of the path's bytes
//              (wrap-around u32 sums of w[rel] * byte, separator
//              included — equal for equal paths either way).
// Returns total bytes written.
int64_t mt_assemble_paths(const uint8_t* combined,
                          const int32_t* src, const int32_t* len,
                          int64_t P, int64_t n_p,
                          const uint32_t* w1, const uint32_t* w2,
                          uint8_t* out_codes, uint64_t* out_hash) {
  init_codes();
  int64_t w = 0;
  for (int64_t p = 0; p < P; p++) {
    uint32_t h1 = 0, h2 = 0;
    int64_t rel = 0;
    const int32_t* ps = src + p * n_p;
    const int32_t* pl = len + p * n_p;
    for (int64_t j = 0; j < n_p; j++) {
      const uint8_t* s = combined + ps[j];
      const int32_t  n = pl[j];
      for (int32_t i = 0; i < n; i++) {
        const uint8_t b = s[i];
        h1 += w1[rel] * (uint32_t)b;
        h2 += w2[rel] * (uint32_t)b;
        rel++;
        out_codes[w++] = CODE[b];
      }
    }
    out_hash[p] = ((uint64_t)h1 << 32) | (uint64_t)h2;
  }
  return w;
}


// Transfer packing: uint8 codes -> 2-bit planes + validity bitmask
// (the host->device wire format, kcore/pack.py pack_transfer_np).
// rows x L row-major; planes ceil(L/4), vbits ceil(L/8) per row.
void mt_pack_transfer(const uint8_t* codes, int64_t rows, int64_t L,
                      uint8_t* planes, uint8_t* vbits) {
  const int64_t p4 = (L + 3) / 4, p8 = (L + 7) / 8;
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* c = codes + r * L;
    uint8_t* pl = planes + r * p4;
    uint8_t* vb = vbits + r * p8;
    for (int64_t i = 0; i < p4; i++) {
      uint8_t b = 0;
      const int64_t base = i * 4;
      const int64_t m = (L - base) < 4 ? (L - base) : 4;
      for (int64_t j = 0; j < m; j++) {
        const uint8_t v = c[base + j];
        if (v < 4) b |= (uint8_t)(v << (2 * j));
      }
      pl[i] = b;
    }
    for (int64_t i = 0; i < p8; i++) {
      uint8_t b = 0;
      const int64_t base = i * 8;
      const int64_t m = (L - base) < 8 ? (L - base) : 8;
      for (int64_t j = 0; j < m; j++) {
        if (c[base + j] < 4) b |= (uint8_t)(1 << j);
      }
      vb[i] = b;
    }
  }
}


// Union of [lo, hi) intervals -> 0/1 plane via a difference array.
// Intervals may arrive unsorted; int16 depth bounds overlap at 32767
// (one cluster's adjust spans stay <= 2k+1, but nothing upstream
// enforces that, so don't assume int8 headroom).
void mt_intervals_plane(const int64_t* lo, const int64_t* hi, int64_t n,
                        int64_t n_win, uint8_t* out) {
  int16_t* d = (int16_t*)calloc((size_t)n_win + 1, sizeof(int16_t));
  if (!d) { memset(out, 0, (size_t)n_win); return; }
  for (int64_t i = 0; i < n; i++) {
    int64_t a = lo[i], b = hi[i];
    if (a < 0) a = 0;
    if (b > n_win) b = n_win;
    if (a < b) { d[a]++; d[b]--; }
  }
  int32_t run = 0;
  for (int64_t i = 0; i < n_win; i++) {
    run += d[i];
    out[i] = run > 0;
  }
  free(d);
}

// Two-pointer merge of two sorted-unique (key u64, val u64) runs,
// summing duplicate keys.  Linear and cache-friendly — replaces the
// O(n log n) argsort merge the counter's binary-counter accumulation
// used (SURVEY.md §2.2 meryl-count role).  out_* must hold na + nb
// entries; returns the merged length.
int64_t mt_merge_counts(const uint64_t* ak, const uint64_t* av, int64_t na,
                        const uint64_t* bk, const uint64_t* bv, int64_t nb,
                        uint64_t* ok, uint64_t* ov) {
  int64_t i = 0, j = 0, m = 0;
  while (i < na && j < nb) {
    uint64_t ka = ak[i], kb = bk[j];
    if (ka < kb)      { ok[m] = ka; ov[m] = av[i]; i++; }
    else if (kb < ka) { ok[m] = kb; ov[m] = bv[j]; j++; }
    else              { ok[m] = ka; ov[m] = av[i] + bv[j]; i++; j++; }
    m++;
  }
  while (i < na) { ok[m] = ak[i]; ov[m] = av[i]; i++; m++; }
  while (j < nb) { ok[m] = bk[j]; ov[m] = bv[j]; j++; m++; }
  return m;
}

}  // extern "C"
