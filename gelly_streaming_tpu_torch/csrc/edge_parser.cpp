// The port's host ingest library: a copy of the JAX package's native edge
// parser (gelly_streaming_tpu/native_src/edge_parser.cpp) cut to the
// exports that ingest needs: count_rows, count_rows_range, fill_edges,
// fill_edges_range, pack_edges, pack_edges40, pack_edges_ef40,
// sort_edges_dst_src, encode_edges_bdv, route_edges and decode_wire_into.
// The bench baselines (cc_baseline, flink_proxy_*) and the serving
// protocol's frame probe (gly1_probe_prefix) are left out.  Built by
// ops/_cuda.host_library with the host C++ compiler and loaded with ctypes
// (utils/native.py), whose calls release the GIL.
//
// Native edge-list parser: the ingest hot path of the host plane.
//
// The reference's ingest is JVM-side text parsing inside Flink sources (e.g.
// ConnectedComponentsExample.java:106-140 readTextFile + split per line).  In
// the TPU framework the host must parse and batch edges fast enough to keep the
// device fed, so the line parser is native: a single mmap-free streaming pass
// with branchless digit scanning, no allocations per line.
//
// Wire format per line:  src SEP dst [SEP value] [SEP timestamp]
// where SEP is any run of spaces/tabs/commas; a value field of "+"/"-" is an
// event sign (EventType.java:24-27 additions/deletions).  Lines starting with
// '#' or '%' are comments.
//
// C ABI (ctypes, no pybind11 in this image):
//   count_rows(path)                      -> number of data lines (or -1)
//   fill_edges(path, src, dst, val, time, sign, cap, ncols_out)
//       fills caller-allocated arrays, returns rows written (or -1).
//       ncols_out reports: 2 = src/dst, 3 = +value, 4 = +timestamp,
//       bit 8 set = value column was a +/- sign.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr size_t kBufSize = 1 << 20;

inline bool is_sep(char c) { return c == ' ' || c == '\t' || c == ','; }

struct LineView {
  const char* p;
  const char* end;
};

// Parse one signed integer or floating token; advances *p past it.
inline bool parse_double(const char** p, const char* end, double* out) {
  char* endptr = nullptr;
  *out = strtod(*p, &endptr);
  if (endptr == *p || endptr > end) return false;
  *p = endptr;
  return true;
}

inline bool parse_i64(const char** p, const char* end, int64_t* out) {
  const char* q = *p;
  bool neg = false;
  if (q < end && (*q == '-' || *q == '+')) {
    neg = (*q == '-');
    ++q;
  }
  if (q >= end || *q < '0' || *q > '9') return false;
  int64_t v = 0;
  while (q < end && *q >= '0' && *q <= '9') {
    v = v * 10 + (*q - '0');
    ++q;
  }
  *out = neg ? -v : v;
  *p = q;
  return true;
}

inline void skip_seps(const char** p, const char* end) {
  while (*p < end && is_sep(**p)) ++(*p);
}

}  // namespace

extern "C" {

int64_t count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* buf = static_cast<char*>(malloc(kBufSize));
  if (!buf) {
    fclose(f);
    return -1;
  }
  int64_t rows = 0;
  bool at_line_start = true;
  bool line_has_data = false;
  bool line_is_comment = false;
  size_t n;
  while ((n = fread(buf, 1, kBufSize, f)) > 0) {
    for (size_t i = 0; i < n; ++i) {
      char c = buf[i];
      if (c == '\n') {
        if (line_has_data && !line_is_comment) ++rows;
        at_line_start = true;
        line_has_data = false;
        line_is_comment = false;
      } else {
        if (at_line_start && (c == '#' || c == '%')) line_is_comment = true;
        if (!is_sep(c) && c != '\r') line_has_data = true;
        at_line_start = false;
      }
    }
  }
  if (line_has_data && !line_is_comment) ++rows;
  free(buf);
  fclose(f);
  return rows;
}

// Byte-range worker plumbing for the PARALLEL ingest pool: a worker owns
// every line whose FIRST byte offset falls in [begin, end_off).  Seeking to
// begin > 0 lands mid-line in general, so the worker reads the byte at
// begin - 1: unless that byte is a newline, the line spanning ``begin``
// started in the previous worker's range and is skipped.  Lines that START
// before end_off are parsed to completion even when they extend past it, so
// adjacent ranges partition the file's lines exactly (no loss, no overlap).
// Returns the file position of the first owned line, or -1 on I/O error.
namespace {
int64_t seek_to_owned_line(FILE* f, int64_t begin, char* line) {
  if (begin <= 0) return 0;
  if (fseek(f, begin - 1, SEEK_SET) != 0) return -1;
  int c = fgetc(f);
  if (c == EOF) return begin;  // range starts at/past EOF: nothing owned
  if (c == '\n') return begin;
  // skip the remainder of the previous range's line (loop: the line may be
  // longer than one buffer fill)
  while (fgets(line, 1 << 16, f)) {
    size_t len = strlen(line);
    if (len > 0 && line[len - 1] == '\n') break;
  }
  return ftell(f);
}
}  // namespace

int64_t fill_edges_range(const char* path, int64_t begin, int64_t end_off,
                         int64_t* src, int64_t* dst, double* val, int64_t* tim,
                         int32_t* sign, int64_t cap, int32_t* ncols_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // Whole-line buffered reader (lines are short; fgets is fine and simple).
  char* line = static_cast<char*>(malloc(1 << 16));
  if (!line) {
    fclose(f);
    return -1;
  }
  int64_t pos = seek_to_owned_line(f, begin, line);
  if (pos < 0) {
    free(line);
    fclose(f);
    return -1;
  }
  int64_t row = 0;
  int32_t ncols = 2;
  bool sign_col = false;
  // at_line_start: a fragment of a line longer than one buffer is still the
  // OWNER's line (it started before end_off), so the range check applies
  // only at true line starts — otherwise the owner would stop mid-line and
  // the next range's skip would drop the middle fragments
  bool at_line_start = true;
  while ((!at_line_start || pos < end_off) && fgets(line, 1 << 16, f)) {
    size_t raw_len = strlen(line);
    pos += static_cast<int64_t>(raw_len);
    at_line_start = raw_len > 0 && line[raw_len - 1] == '\n';
    const char* p = line;
    const char* end = line + raw_len;
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
    skip_seps(&p, end);
    if (p >= end || *p == '#' || *p == '%') continue;
    if (row >= cap) break;
    int64_t s, d;
    if (!parse_i64(&p, end, &s)) continue;
    skip_seps(&p, end);
    if (!parse_i64(&p, end, &d)) continue;
    src[row] = s;
    dst[row] = d;
    val[row] = 0.0;
    tim[row] = 0;
    sign[row] = 1;
    skip_seps(&p, end);
    if (p < end) {
      if ((*p == '+' || *p == '-') &&
          (p + 1 == end || is_sep(p[1]))) {
        sign[row] = (*p == '-') ? -1 : 1;
        sign_col = true;
        if (ncols < 3) ncols = 3;
        ++p;
      } else {
        double v;
        if (parse_double(&p, end, &v)) {
          val[row] = v;
          if (ncols < 3) ncols = 3;
        }
      }
      skip_seps(&p, end);
      if (p < end) {
        int64_t t;
        if (parse_i64(&p, end, &t)) {
          tim[row] = t;
          ncols = 4;
        }
      }
    }
    ++row;
  }
  free(line);
  fclose(f);
  *ncols_out = ncols | (sign_col ? 0x100 : 0);
  return row;
}

int64_t fill_edges(const char* path, int64_t* src, int64_t* dst, double* val,
                   int64_t* tim, int32_t* sign, int64_t cap,
                   int32_t* ncols_out) {
  return fill_edges_range(path, 0, INT64_MAX, src, dst, val, tim, sign, cap,
                          ncols_out);
}

// Data-line count within a byte range — the allocation pass of the parallel
// parser (same ownership rule as fill_edges_range).
int64_t count_rows_range(const char* path, int64_t begin, int64_t end_off) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = static_cast<char*>(malloc(1 << 16));
  if (!line) {
    fclose(f);
    return -1;
  }
  int64_t pos = seek_to_owned_line(f, begin, line);
  if (pos < 0) {
    free(line);
    fclose(f);
    return -1;
  }
  int64_t rows = 0;
  bool at_line_start = true;  // same fragment-ownership rule as fill_edges_range
  while ((!at_line_start || pos < end_off) && fgets(line, 1 << 16, f)) {
    size_t len = strlen(line);
    pos += static_cast<int64_t>(len);
    at_line_start = len > 0 && line[len - 1] == '\n';
    const char* p = line;
    const char* end = line + len;
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
    skip_seps(&p, end);
    if (p >= end || *p == '#' || *p == '%') continue;
    ++rows;
  }
  free(line);
  fclose(f);
  return rows;
}

// Pack a (src, dst) edge batch into the compact device wire format: the src
// block then the dst block, each id truncated to `width` little-endian bytes
// (width in {2, 3, 4}; callers pick the narrowest width that covers the
// stream's vertex capacity).  The host->device link is the streaming data
// plane's bottleneck, so bytes-per-edge is the throughput ceiling; this is the
// native fast path behind gelly_streaming_tpu/io/wire.py.
int64_t pack_edges(const int32_t* src, const int32_t* dst, int64_t n,
                   int32_t width, uint8_t* out) {
  if (width < 1 || width > 4) return -1;
  const uint16_t kEndianProbe = 1;
  const bool kLittleEndian =
      *reinterpret_cast<const uint8_t*>(&kEndianProbe) == 1;
  const int32_t* blocks[2] = {src, dst};
  uint8_t* q = out;
  for (const int32_t* block : blocks) {
    switch (width) {
      case 4:
        if (kLittleEndian) {  // int32 memory bytes == little-endian wire
          // n == 0 skips the copy: memcpy's pointer args are declared
          // never-null, and an empty batch's buffer may be exactly that
          // (UBSan finding from the sanitizer fuzz gate)
          if (n > 0) memcpy(q, block, (size_t)n * 4);
          q += n * 4;
        } else {
          for (int64_t i = 0; i < n; ++i) {
            uint32_t v = static_cast<uint32_t>(block[i]);
            q[0] = v & 0xFF;
            q[1] = (v >> 8) & 0xFF;
            q[2] = (v >> 16) & 0xFF;
            q[3] = (v >> 24) & 0xFF;
            q += 4;
          }
        }
        break;
      case 3:
        for (int64_t i = 0; i < n; ++i) {
          uint32_t v = static_cast<uint32_t>(block[i]);
          q[0] = v & 0xFF;
          q[1] = (v >> 8) & 0xFF;
          q[2] = (v >> 16) & 0xFF;
          q += 3;
        }
        break;
      case 2:
        for (int64_t i = 0; i < n; ++i) {
          uint32_t v = static_cast<uint32_t>(block[i]);
          q[0] = v & 0xFF;
          q[1] = (v >> 8) & 0xFF;
          q += 2;
        }
        break;
      case 1:
        for (int64_t i = 0; i < n; ++i) *q++ = block[i] & 0xFF;
        break;
    }
  }
  return q - out;
}

// Tightest wire format for vertex spaces up to 2^20: each (src, dst) pair is
// packed into 5 bytes (20 bits per id, little-endian; dst occupies the high
// nibble of byte 2 upward).  5 bytes/edge vs 6 for the 3-byte-per-id block
// format — the host->device link is the bottleneck, so this is ~17% more
// stream throughput when ids fit.
int64_t pack_edges40(const int32_t* src, const int32_t* dst, int64_t n,
                     uint8_t* out) {
  uint8_t* q = out;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t s = static_cast<uint32_t>(src[i]) & 0xFFFFF;
    uint32_t d = static_cast<uint32_t>(dst[i]) & 0xFFFFF;
    uint64_t w = static_cast<uint64_t>(s) | (static_cast<uint64_t>(d) << 20);
    q[0] = w & 0xFF;
    q[1] = (w >> 8) & 0xFF;
    q[2] = (w >> 16) & 0xFF;
    q[3] = (w >> 24) & 0xFF;
    q[4] = (w >> 32) & 0xFF;
    q += 5;
  }
  return q - out;
}

// Elias-Fano pack of a src-GROUPED edge batch for vertex spaces up to 2^20 —
// the "order-free" wire mode: when the consumer's fold is order-insensitive
// (e.g. streaming CC union), the host may regroup the micro-batch and ship
// only the multiset.  Layout: a unary src histogram bitvector of n + capacity
// bits (count[v] ones then a zero per vertex) followed by the dst ids in
// src-grouped order (stable within a group), packed 20-bit two-per-5-bytes as
// in pack_edges40.  A full (src, dst) sort is NOT needed: the decoder pairs
// the i-th low with the i-th unary one, so any dst order within a src group
// decodes to the same multiset — which is why the pack is a counting sort by
// src (3 linear passes, no 64-bit keys) instead of a radix sort.  Total
// (n+cap)/8 + 2.5n bytes ~= 2.6-2.9 B/edge vs 5 — worth it when host cores
// are plentiful; on a single-core host even this pack competes with the
// transfer for CPU and the plain 40-bit pack wins (io/wire.py documents the
// measured tradeoff).
int64_t pack_edges_ef40(const int32_t* src, const int32_t* dst, int64_t n,
                        int32_t capacity, uint8_t* out, int64_t out_cap) {
  if (capacity <= 0 || capacity > (1 << 20) || n < 0) return -1;
  int64_t bvbytes = (n + capacity + 7) / 8;
  int64_t lowbytes = ((n + 1) / 2) * 5;
  if (out_cap < bvbytes + lowbytes) return -1;
  // size widened BEFORE the arithmetic: (n + 1) * 4 would overflow in
  // int64/int32 first and only then convert (the NATIVEOVFL shape)
  uint32_t* lows = static_cast<uint32_t*>(malloc(((size_t)n + 1) * 4));
  if (!lows) return -1;
  memset(out, 0xFF, bvbytes);

  // Counting sort by src, cache-blocked: a flat per-vertex offset table is
  // 4 MB at capacity 2^20, so the scatter pass takes a cache miss per edge
  // and caps the pack ~37M eps on this host.  Two-level variant: first
  // scatter (src, dst) pairs into buckets of 2^12 consecutive src ids (the
  // bucket cursor table is B <= 256 words, L1-resident; bucket writes are
  // 256 sequential streams), then counting-sort each bucket with a 16 KB
  // sub-table.  Output bytes are identical to the flat sort: buckets are
  // src-ranges in order, the sub-sort is stable, so the concatenation is
  // the same stable src-grouped order.
  const int SUB_BITS = 12;
  const int32_t SUB = 1 << SUB_BITS;
  int32_t nbuckets = (capacity + SUB - 1) >> SUB_BITS;
  bool blocked = capacity > (1 << 14) && n >= (int64_t)1 << 16;
  uint64_t* tmp = nullptr;
  if (blocked) {
    tmp = static_cast<uint64_t*>(malloc((size_t)n * 8));
    if (!tmp) blocked = false;  // fall back to the flat path
  }
  if (blocked) {
    uint32_t* bcur =
        static_cast<uint32_t*>(calloc((size_t)nbuckets + 1, 4));
    uint32_t* sub = static_cast<uint32_t*>(malloc(((size_t)SUB + 1) * 4));
    if (!bcur || !sub) {
      free(bcur);
      free(sub);
      free(tmp);
      free(lows);
      return -1;
    }
    for (int64_t i = 0; i < n; ++i) bcur[((uint32_t)src[i] & 0xFFFFF) >> SUB_BITS]++;
    {
      uint32_t sum = 0;
      for (int32_t b = 0; b <= nbuckets; ++b) {
        uint32_t c = (b < nbuckets) ? bcur[b] : 0;
        bcur[b] = sum;
        sum += c;
      }
    }
    for (int64_t i = 0; i < n; ++i) {
      uint32_t s = (uint32_t)src[i] & 0xFFFFF;
      tmp[bcur[s >> SUB_BITS]++] = (uint64_t)s |
                                   ((uint64_t)((uint32_t)dst[i] & 0xFFFFF) << 32);
    }
    // bcur[b] is now the END of bucket b (the cursor ran through it)
    int64_t done = 0;  // edges emitted before the current bucket
    for (int32_t b = 0; b < nbuckets; ++b) {
      int64_t lo = (b == 0) ? 0 : bcur[b - 1];
      int64_t hi = bcur[b];
      int32_t base_v = b << SUB_BITS;
      int32_t span = capacity - base_v < SUB ? capacity - base_v : SUB;
      memset(sub, 0, ((size_t)span + 1) * 4);
      for (int64_t i = lo; i < hi; ++i) sub[(tmp[i] & 0xFFFFF) - base_v]++;
      {  // exclusive prefix, based at the global edge count before the bucket
        uint32_t sum = (uint32_t)done;
        for (int32_t v = 0; v <= span; ++v) {
          uint32_t c = (v < span) ? sub[v] : 0;
          sub[v] = sum;
          sum += c;
        }
      }
      for (int64_t i = lo; i < hi; ++i) {
        lows[sub[(tmp[i] & 0xFFFFF) - base_v]++] = (uint32_t)(tmp[i] >> 32);
      }
      // the scatter cursor leaves sub[v] at the END offset of vertex
      // base_v+v's group; its terminating zero in the unary bitvector sits
      // after that many ones plus one zero per prior vertex
      for (int32_t v = 0; v < span; ++v) {
        int64_t p = (int64_t)sub[v] + base_v + v;
        out[p >> 3] &= static_cast<uint8_t>(~(1u << (p & 7)));
      }
      done = hi;
    }
    free(bcur);
    free(sub);
    free(tmp);
  } else {
    uint32_t* off = static_cast<uint32_t*>(calloc((size_t)capacity + 1, 4));
    if (!off) {
      free(lows);
      return -1;
    }
    for (int64_t i = 0; i < n; ++i) off[(uint32_t)src[i] & 0xFFFFF]++;
    // exclusive prefix -> group offsets
    {
      uint32_t sum = 0;
      for (int32_t v = 0; v <= capacity; ++v) {
        uint32_t c = (v < capacity) ? off[v] : 0;
        off[v] = sum;
        sum += c;
      }
    }
    // unary bitvector from the offsets: all ones, then clear each group's
    // terminating zero (cap single-bit clears instead of n bit-by-bit sets)
    for (int32_t v = 0; v < capacity; ++v) {
      int64_t p = (int64_t)off[v + 1] + v;  // ones before zero + prior zeros
      out[p >> 3] &= static_cast<uint8_t>(~(1u << (p & 7)));
    }
    for (int64_t i = 0; i < n; ++i) {
      lows[off[(uint32_t)src[i] & 0xFFFFF]++] = (uint32_t)dst[i] & 0xFFFFF;
    }
    free(off);
  }
  // trailing pad bits of the last byte must be zero (byte parity with the
  // numpy packbits fallback; the decoder ignores them either way)
  for (int64_t p = n + capacity; p < bvbytes * 8; ++p) {
    out[p >> 3] &= static_cast<uint8_t>(~(1u << (p & 7)));
  }
  lows[n] = 0;  // pad partner for odd n
  uint8_t* q = out + bvbytes;
  int64_t npairs = (n + 1) / 2;
  // bulk pairs: one unaligned 8-byte store each (3 bytes of overrun are
  // rewritten by the next pair); the final pair writes exactly 5 bytes so
  // the buffer end is never crossed.  The memcpy trick assumes the uint64's
  // in-memory bytes ARE the little-endian wire bytes — true only on a
  // little-endian host; big-endian builds take the explicit byte stores so
  // native output stays bit-identical to the numpy fallback.
  const uint16_t kEndianProbe = 1;
  const bool kLittleEndian =
      *reinterpret_cast<const uint8_t*>(&kEndianProbe) == 1;
  if (kLittleEndian) {
    for (int64_t i = 0; i + 1 < npairs; ++i) {
      uint64_t w = (uint64_t)lows[2 * i] | ((uint64_t)lows[2 * i + 1] << 20);
      memcpy(q, &w, 8);
      q += 5;
    }
  } else {
    for (int64_t i = 0; i + 1 < npairs; ++i) {
      uint64_t w = (uint64_t)lows[2 * i] | ((uint64_t)lows[2 * i + 1] << 20);
      q[0] = w & 0xFF;
      q[1] = (w >> 8) & 0xFF;
      q[2] = (w >> 16) & 0xFF;
      q[3] = (w >> 24) & 0xFF;
      q[4] = (w >> 32) & 0xFF;
      q += 5;
    }
  }
  if (npairs > 0) {
    uint64_t w = (uint64_t)lows[2 * (npairs - 1)] |
                 ((uint64_t)lows[2 * npairs - 1] << 20);
    q[0] = w & 0xFF;
    q[1] = (w >> 8) & 0xFF;
    q[2] = (w >> 16) & 0xFF;
    q[3] = (w >> 24) & 0xFF;
    q[4] = (w >> 32) & 0xFF;
    q += 5;
  }
  free(lows);
  return q - out;
}

// ---------------------------------------------------------------------------
// Propagation-blocking ingest (arXiv:2011.08451, arXiv:1608.01362): bin a
// micro-batch by destination so the device fold's scatter walks the summary
// arrays in order (cache-resident segments instead of random [C] misses), and
// the wire encoder below can ship small sorted deltas instead of full ids.
//
// sort_edges_dst_src: stable counting sort of an edge batch by (dst, src) —
// the bin pass.  Two passes of a cache-blocked counting sort (by src first,
// then stably by dst) so the count tables stay L1/L2-resident at any capacity
// the Python side routes here (it falls back to numpy lexsort beyond 2^22).
// Output order is exactly numpy's lexsort((src, dst)) — byte-identical wire
// buffers whichever path packs (pinned by tests/test_wire_bdv.py).

namespace {

// One stable counting-sort pass of (key, carry) pairs; keys < capacity.
// in_k/in_c -> out_k/out_c.  Returns false on alloc failure.
bool counting_pass(const int32_t* in_k, const int32_t* in_c, int64_t n,
                   int32_t capacity, int32_t* out_k, int32_t* out_c) {
  uint32_t* off = static_cast<uint32_t*>(calloc((size_t)capacity + 1, 4));
  if (!off) return false;
  for (int64_t i = 0; i < n; ++i) off[(uint32_t)in_k[i]]++;
  uint32_t sum = 0;
  for (int32_t v = 0; v <= capacity; ++v) {
    uint32_t c = (v < capacity) ? off[v] : 0;
    off[v] = sum;
    sum += c;
  }
  for (int64_t i = 0; i < n; ++i) {
    uint32_t slot = off[(uint32_t)in_k[i]]++;
    out_k[slot] = in_k[i];
    out_c[slot] = in_c[i];
  }
  free(off);
  return true;
}

// LSB radix sort of packed (dst << 28 | src) keys: 4 stable passes of
// 14-bit digits, 64 KB count tables (cache-resident at ANY capacity — the
// per-vertex counting tables above stop fitting past ~2^22 ids).  Requires
// ids < 2^28 (the BDV varint bound).  Returns false on alloc failure.
bool radix_sort_dst_src(const int32_t* src, const int32_t* dst, int64_t n,
                        int32_t* out_src, int32_t* out_dst) {
  constexpr int kDigit = 14;
  constexpr uint32_t kMask = (1u << kDigit) - 1;
  uint64_t* a = static_cast<uint64_t*>(malloc((size_t)n * 8));
  uint64_t* b = static_cast<uint64_t*>(malloc((size_t)n * 8));
  uint32_t* count = static_cast<uint32_t*>(malloc((1u << kDigit) * 4));
  if (!a || !b || !count) {
    free(a);
    free(b);
    free(count);
    return false;
  }
  for (int64_t i = 0; i < n; ++i) {
    a[i] = ((uint64_t)(uint32_t)dst[i] << 28) | (uint32_t)src[i];
  }
  uint64_t* from = a;
  uint64_t* to = b;
  for (int shift = 0; shift < 56; shift += kDigit) {
    memset(count, 0, (1u << kDigit) * 4);
    for (int64_t i = 0; i < n; ++i) count[(from[i] >> shift) & kMask]++;
    uint32_t sum = 0;
    for (uint32_t d = 0; d < (1u << kDigit); ++d) {
      uint32_t c = count[d];
      count[d] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      to[count[(from[i] >> shift) & kMask]++] = from[i];
    }
    uint64_t* t = from;
    from = to;
    to = t;
  }
  for (int64_t i = 0; i < n; ++i) {  // 4 passes: result is back in `a`
    out_src[i] = (int32_t)(from[i] & ((1u << 28) - 1));
    out_dst[i] = (int32_t)(from[i] >> 28);
  }
  free(a);
  free(b);
  free(count);
  return true;
}

}  // namespace

// Sort an edge batch by (dst, src), stable — src ascending within equal dst.
// Writes the sorted batch into out_src/out_dst (must not alias the inputs).
// Per-vertex counting sorts up to 2^22 ids (tables within cache), the
// packed-key radix sort beyond (ids must fit the 28-bit BDV bound there).
// Returns n, or -1 on error (ids out of [0, capacity), alloc failure).
int64_t sort_edges_dst_src(const int32_t* src, const int32_t* dst, int64_t n,
                           int32_t capacity, int32_t* out_src,
                           int32_t* out_dst) {
  if (capacity <= 0 || n < 0 || capacity > (1 << 28)) return -1;
  for (int64_t i = 0; i < n; ++i) {
    if ((uint32_t)src[i] >= (uint32_t)capacity ||
        (uint32_t)dst[i] >= (uint32_t)capacity)
      return -1;
  }
  if (capacity > (1 << 22)) {
    return radix_sort_dst_src(src, dst, n, out_src, out_dst) ? n : -1;
  }
  int32_t* tk = static_cast<int32_t*>(malloc((size_t)n * 4));
  int32_t* tc = static_cast<int32_t*>(malloc((size_t)n * 4));
  if (!tk || !tc) {
    free(tk);
    free(tc);
    return -1;
  }
  // pass 1: by src (key = src, carry = dst); pass 2: stably by dst
  bool ok = counting_pass(src, dst, n, capacity, tk, tc) &&
            counting_pass(tc, tk, n, capacity, out_dst, out_src);
  free(tk);
  free(tc);
  return ok ? n : -1;
}

// Delta/group-varint wire encode of a dst-SORTED edge batch.  Per edge the
// value stream carries the dst delta from the previous edge (unsigned —
// sorted, so mostly 0/tiny) then the src as a GLOBAL zigzag delta
// src[i] - src[i-1] (src[-1] = 0; the chain telescopes, so the decoder is
// one cumsum, and on community-clustered graphs consecutive sorted edges
// share a neighborhood so the deltas stay small across dst-run boundaries).
//
// The stream is GROUP varint, not LEB128: a control block of 2-bit byte
// lengths (1..4, four values per control byte, value k at control[k>>2]
// bits 2*(k&3)) sits at the buffer head, followed by the little-endian
// value bytes.  The device decoder (ops/wire_decode.py) then needs only a
// cumsum of lengths and four clipped gathers — no per-byte scan, and no
// scatter, which XLA's CPU backend lowers to a serial loop.  Denser than
// LEB128 too: 8-bit payloads + 0.25 amortized control vs 7+1 per byte.
// Callers bucket-pad for shape-stable transfers (zero padding decodes as
// never-asked-for zero-length groups).  Returns total bytes written
// (control + data), or -1 (dst not sorted, buffer too small).
int64_t encode_edges_bdv(const int32_t* src, const int32_t* dst, int64_t n,
                         uint8_t* out, int64_t out_cap) {
  int64_t count = 2 * n;
  int64_t ctrl = (count + 3) / 4;
  if (out_cap < ctrl + 8 * n) return -1;
  memset(out, 0, ctrl);
  uint8_t* q = out + ctrl;
  int32_t prev_d = 0;
  int32_t prev_s = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t dd = dst[i] - prev_d;
    if (dd < 0) return -1;
    int32_t ds = src[i] - prev_s;
    uint32_t vals2[2] = {
        (uint32_t)dd,
        ((uint32_t)ds << 1) ^ (uint32_t)(ds >> 31),
    };
    for (int v = 0; v < 2; ++v) {
      uint32_t x = vals2[v];
      int len = 1 + (x >= 0x100u) + (x >= 0x10000u) + (x >= 0x1000000u);
      int64_t k = 2 * i + v;
      out[k >> 2] |= (uint8_t)((len - 1) << ((k & 3) * 2));
      for (int j = 0; j < len; ++j) {
        *q++ = (uint8_t)(x & 0xFF);
        x >>= 8;
      }
    }
    prev_d = dst[i];
    prev_s = src[i];
  }
  return q - out;
}

// Host keyBy router: scatter edges into per-owner-shard buckets in ONE pass
// (owner = key % num_shards; key is src or dst).  The numpy path selects each
// shard's edges with a boolean mask — S full passes over the batch; this is
// the native equivalent of the reference runtime's hash partitioner feeding
// the network shuffle (SummaryBulkAggregation.java:78).  Buckets are
// [num_shards, cap] row-major; arrival order is preserved within a shard
// (stable, matching the numpy path).  Returns edges written, or -1 on a
// bucket overflow (cap too small) so callers never drop silently.
int64_t route_edges(const int32_t* src, const int32_t* dst, int64_t n,
                    int32_t num_shards, int32_t key_is_src, int64_t cap,
                    int32_t* out_src, int32_t* out_dst, int64_t* counts) {
  if (num_shards <= 0 || cap <= 0) return -1;
  for (int32_t s = 0; s < num_shards; ++s) counts[s] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t key = key_is_src ? src[i] : dst[i];
    // floored modulo, matching Python/numpy '%' for negative keys (a vertex
    // id that wrapped negative must land on the same owner everywhere)
    int32_t owner = key % num_shards;
    if (owner < 0) owner += num_shards;
    int64_t k = counts[owner];
    if (k >= cap) return -1;
    int64_t slot = static_cast<int64_t>(owner) * cap + k;
    out_src[slot] = src[i];
    out_dst[slot] = dst[i];
    counts[owner] = k + 1;
  }
  int64_t total = 0;
  for (int32_t s = 0; s < num_shards; ++s) total += counts[s];
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The one-pass validate + decode (+ bin) of a wire buffer into caller-owned
// arrays (io/wire.decode_wire_into).

namespace {

// Fixed-width block decode: src block then dst block, each id `w`
// little-endian bytes (io/wire.py pack_edges layout).
void decode_fixed_blocks(const uint8_t* buf, int64_t n, int32_t w,
                         int32_t* out_src, int32_t* out_dst) {
  int32_t* outs[2] = {out_src, out_dst};
  for (int b = 0; b < 2; ++b) {
    const uint8_t* q = buf + (int64_t)b * n * w;
    int32_t* out = outs[b];
    for (int64_t i = 0; i < n; ++i) {
      uint32_t v = 0;
      for (int32_t k = 0; k < w; ++k) v |= (uint32_t)q[k] << (8 * k);
      out[i] = (int32_t)v;
      q += w;
    }
  }
}

// 40-bit pair decode (io/wire.py _unpack_edges40): 5 bytes per edge, src in
// bits 0..19, dst in bits 20..39.
void decode_pair40(const uint8_t* buf, int64_t n, int32_t* out_src,
                   int32_t* out_dst) {
  const uint8_t* q = buf;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t lo = (uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                  ((uint32_t)q[2] << 16);
    uint32_t hi = ((uint32_t)q[2] >> 4) | ((uint32_t)q[3] << 4) |
                  ((uint32_t)q[4] << 12);
    out_src[i] = (int32_t)(lo & 0xFFFFF);
    out_dst[i] = (int32_t)hi;
    q += 5;
  }
}

// BDV decode, the twin of io/wire.unpack_edges_bdv_host: 2n group varints
// (control block of 2-bit lengths, then little-endian value bytes), dst as
// unsigned deltas, src as global zigzag deltas — both one running sum, with
// int64 accumulation truncated to int32 per element exactly like the numpy
// path's cumsum().astype(int32).  Returns n, or -3 when the control block
// declares more bytes than the buffer holds (truncation — the same refusal
// _varint_decode_np phrases).
int64_t decode_bdv_into(const uint8_t* buf, int64_t nbytes, int64_t n,
                        int32_t* out_src, int32_t* out_dst) {
  int64_t count = 2 * n;
  int64_t ctrl = (count + 3) / 4;
  if (nbytes < ctrl) return -3;
  int64_t needed = ctrl;
  for (int64_t k = 0; k < count; ++k) {
    needed += ((buf[k >> 2] >> (2 * (k & 3))) & 3) + 1;
  }
  if (nbytes < needed) return -3;
  const uint8_t* q = buf + ctrl;
  int64_t d_acc = 0;
  int64_t s_acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t vals2[2];
    for (int v = 0; v < 2; ++v) {
      int64_t k = 2 * i + v;
      int32_t len = ((buf[k >> 2] >> (2 * (k & 3))) & 3) + 1;
      uint32_t x = 0;
      for (int32_t j = 0; j < len; ++j) x |= (uint32_t)(*q++) << (8 * j);
      vals2[v] = x;
    }
    d_acc += (int64_t)vals2[0];
    int64_t ds = (int64_t)(vals2[1] >> 1) ^ -(int64_t)(vals2[1] & 1);
    s_acc += ds;
    out_dst[i] = (int32_t)d_acc;
    out_src[i] = (int32_t)s_acc;
  }
  return n;
}

}  // namespace

extern "C" {

// One-pass validate + decode (+ optional (dst, src) binning) of a pushed
// wire buffer into caller-owned int32[n] arrays — the decode pool's whole
// per-buffer hot path in a single GIL-free call.
//
// width_code: 2/3/4 = fixed byte widths, 5 = PAIR40, 6 = BDV (io/wire.py
// encodings; EF40 never crosses the push boundary).  sort != 0 applies
// sort_edges_dst_src to the decoded batch in the same pass (requires
// capacity within the sorter's 2^28 bound).
//
// Returns n on success; negative typed refusals the Python wrapper maps
// back through the numpy oracle: -1 buffer size/bounds violation, -2 a
// decoded id outside [0, capacity), -3 truncated BDV stream, -4 internal
// (alloc failure / sort out of range) — the one code that means "fall back
// to the numpy twin", never "refuse the client".
// untrusted: buf[nbytes] — attacker-controlled wire bytes off the socket;
// every decode branch below compares nbytes before touching the buffer
int64_t decode_wire_into(const uint8_t* buf, int64_t nbytes, int64_t n,
                         int32_t width_code, int32_t capacity, int32_t sort,
                         int32_t* out_src, int32_t* out_dst) {
  // n == 0 decodes trivially (and must: the numpy oracle ACCEPTS an empty
  // batch with an empty buffer, and the fuzz corpus pins verdict parity —
  // refusing here made the wrapper flag a false decoder drift)
  if (n < 0 || capacity <= 0) return -1;
  int32_t* s = out_src;
  int32_t* d = out_dst;
  int32_t* tmp = nullptr;
  if (sort) {
    tmp = static_cast<int32_t*>(malloc((size_t)n * 8));
    if (!tmp) return -4;
    s = tmp;
    d = tmp + n;
  }
  int64_t rc = n;
  switch (width_code) {
    case 2:
    case 3:
    case 4:
      if (nbytes != 2 * n * width_code) {
        rc = -1;
      } else {
        decode_fixed_blocks(buf, n, width_code, s, d);
      }
      break;
    case 5:
      if (nbytes != 5 * n) {
        rc = -1;
      } else {
        decode_pair40(buf, n, s, d);
      }
      break;
    case 6: {
      // the validation window of core/stream.validate_wire_buffer: BDV
      // buffers are data-dependent sizes in [floor, worst-case bound].
      // The bound must mirror wire.bdv_max_nbytes EXACTLY — including its
      // max(n, 1): an empty batch may carry up to 9 pad bytes the oracle
      // accepts, so a plain 9 * n here refused buffers the numpy twin
      // takes and the wrapper flagged false decoder drift (fuzz corpus
      // regression bdv_empty_batch_slack.bin)
      int64_t bdv_min = (2 * n + 3) / 4 + 2 * n;
      int64_t bdv_max = 9 * (n > 0 ? n : (int64_t)1);
      if (nbytes > bdv_max || nbytes < bdv_min) {
        rc = -1;
      } else {
        rc = decode_bdv_into(buf, nbytes, n, s, d);
      }
      break;
    }
    default:
      rc = -4;  // unknown encoding: the Python twin owns it
  }
  if (rc >= 0) {
    // both ends of the id range before anything is handed downstream
    // (BDV's signed zigzag deltas can express negative ids, whose device
    // scatters would silently wrap to the summary tail)
    for (int64_t i = 0; i < n; ++i) {
      if ((uint32_t)s[i] >= (uint32_t)capacity ||
          (uint32_t)d[i] >= (uint32_t)capacity) {
        rc = -2;
        break;
      }
    }
  }
  if (rc >= 0 && sort) {
    rc = sort_edges_dst_src(s, d, n, capacity, out_src, out_dst) == n ? n : -4;
  }
  free(tmp);
  return rc;
}

}  // extern "C"
