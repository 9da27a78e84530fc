// Native FASTX parser + 2-bit base encoder.
//
// Counterpart of the reference's host-side C++ (the
// kmer_searcher's producer thread, kmer_searcher.cpp:153-201, and the
// pigz/seqkit decompression/conversion subprocesses, fastx_io.py:186-227):
// all k-mer math happens on the device, so the only native work left is
// feeding bases to the device as fast as the disk allows. This library
// parses FASTA/FASTQ (plain or gzip via zlib), encodes A/C/G/T -> 0..3
// (case-insensitive, anything else -> 4, matching
// fedrann_jax/io/packing.py), and returns contiguous buffers that numpy
// wraps zero-copy through ctypes.
//
// C ABI only — no pybind11 in this toolchain.

#include <zlib.h>

#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffers {
  std::vector<uint8_t> codes;       // concatenated base codes
  std::vector<uint64_t> offsets;    // n_reads + 1 offsets into codes
  std::vector<char> names;          // concatenated NUL-terminated names
  std::vector<uint64_t> name_offsets;  // n_reads offsets into names
};

// This platform's VMs stall pathologically on LARGE single write()s to
// ext4: a 31 MB write measures 12-20 s (dirty-page throttling kicks in
// per-syscall) while the same bytes in <=1 MB slices land in the page
// cache at full speed (~0.04 s). Every bulk file write must go through
// this slicer.
size_t fwrite_chunked(const char* data, size_t n, FILE* f) {
  const size_t kChunk = 1 << 20;
  size_t done = 0;
  while (done < n) {
    size_t step = n - done < kChunk ? n - done : kChunk;
    size_t w = fwrite(data + done, 1, step, f);
    done += w;
    if (w != step) break;
  }
  return done;
}

uint8_t g_lut[256];

void init_lut() {
  static bool done = false;
  if (done) return;
  memset(g_lut, 4, sizeof(g_lut));
  g_lut[(unsigned)'A'] = g_lut[(unsigned)'a'] = 0;
  g_lut[(unsigned)'C'] = g_lut[(unsigned)'c'] = 1;
  g_lut[(unsigned)'G'] = g_lut[(unsigned)'g'] = 2;
  g_lut[(unsigned)'T'] = g_lut[(unsigned)'t'] = 3;
  done = true;
}

// ---- block-based record parsers ----------------------------------------
//
// The old path walked the stream with gzgets line-by-line (a std::string
// alloc/copy per line); these parse whole decompressed blocks in place with
// memchr, consuming only COMPLETE records and telling the caller how many
// bytes they used, so a producer thread can keep decompressing the next
// block while this thread parses (the pigz-role overlap the reference gets
// from subprocess pipes, fastx_io.py:205-227).

void append_name_span(Buffers* b, const char* data, size_t ns, size_t ne) {
  b->name_offsets.push_back(b->names.size());
  b->names.insert(b->names.end(), data + ns, data + ne);
  b->names.push_back('\0');
}

void append_seq_span(Buffers* b, const char* data, size_t i, size_t stop) {
  size_t cur = b->codes.size();
  b->codes.resize(cur + (stop - i));
  uint8_t* dst = b->codes.data() + cur;
  for (size_t j = i; j < stop; ++j) dst[j - i] = g_lut[(unsigned char)data[j]];
}

// Parse complete FASTA records from data[0..len). A record is complete
// when the next '>' begins a line inside the buffer, or at eof. Returns
// bytes consumed (always a record boundary unless eof).
size_t parse_fasta_block(const char* data, size_t len, bool eof, Buffers* b) {
  size_t i = 0, consumed = 0;
  for (;;) {
    while (i < len && (data[i] == '\n' || data[i] == '\r')) ++i;
    if (i >= len) return len;  // only blanks left: consume them
    if (data[i] != '>') return consumed;  // caller reports bad format
    const char* nl = (const char*)memchr(data + i, '\n', len - i);
    if (!nl && !eof) return consumed;  // header incomplete
    size_t line_end = nl ? (size_t)(nl - data) : len;
    // name = first token after '>'
    size_t ns = i + 1, ne = ns;
    while (ne < line_end && data[ne] != ' ' && data[ne] != '\t' &&
           data[ne] != '\r')
      ++ne;
    // find the record's end (next '>' at line start) BEFORE committing
    size_t j = nl ? line_end + 1 : len;
    size_t rec_end = len;
    bool complete = eof;
    for (size_t p = j; p < len;) {
      if (data[p] == '>') { rec_end = p; complete = true; break; }
      const char* e = (const char*)memchr(data + p, '\n', len - p);
      if (!e) { if (eof) rec_end = len; break; }
      p = (size_t)(e - data) + 1;
    }
    if (!complete) return consumed;
    append_name_span(b, data, ns, ne);
    for (size_t p = j; p < rec_end;) {
      const char* e = (const char*)memchr(data + p, '\n', rec_end - p);
      size_t le = e ? (size_t)(e - data) : rec_end;
      size_t stop = le;
      while (stop > p && data[stop - 1] == '\r') --stop;
      append_seq_span(b, data, p, stop);
      p = le + 1;
    }
    b->offsets.push_back(b->codes.size());
    i = rec_end;
    consumed = i;
  }
}

// Parse complete 4-line FASTQ records. Returns bytes consumed.
size_t parse_fastq_block(const char* data, size_t len, bool eof, Buffers* b) {
  size_t i = 0, consumed = 0;
  for (;;) {
    while (i < len && (data[i] == '\n' || data[i] == '\r')) ++i;
    if (i >= len) return len;  // trailing blanks fully consumed
    if (data[i] != '@') return consumed;  // bad format for caller
    // locate the 4 line ends
    size_t ends[4];
    size_t p = i;
    for (int l = 0; l < 4; ++l) {
      const char* e = (const char*)memchr(data + p, '\n', len - p);
      if (!e) {
        // a final quality line without trailing newline is fine at eof;
        // a record missing its quality bytes entirely is truncated
        if (!eof || l < 3 || p >= len) return consumed;
        ends[l] = len;
        p = len;
        break;
      }
      ends[l] = (size_t)(e - data);
      p = ends[l] + 1;
    }
    size_t h_end = ends[0];
    size_t ns = i + 1, ne = ns;
    while (ne < h_end && data[ne] != ' ' && data[ne] != '\t' &&
           data[ne] != '\r')
      ++ne;
    append_name_span(b, data, ns, ne);
    size_t ss = ends[0] + 1, se = ends[1];
    while (se > ss && data[se - 1] == '\r') --se;
    append_seq_span(b, data, ss, se);
    b->offsets.push_back(b->codes.size());
    i = (ends[3] < len) ? ends[3] + 1 : len;
    consumed = i;
  }
}

// Bounded queue of decompressed chunks: one producer (gzread), one
// consumer (block parser).
struct ChunkQueue {
  std::mutex m;
  std::condition_variable cv;
  std::deque<std::vector<char>> q;
  bool done = false;
  int error = 0;
  static constexpr size_t kMaxDepth = 4;

  // false => consumer already finished (producer should stop)
  bool push(std::vector<char>&& chunk) {
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return q.size() < kMaxDepth || done; });
    if (done) return false;
    q.emplace_back(std::move(chunk));
    cv.notify_all();
    return true;
  }
  // false => stream finished (done and drained)
  bool pop(std::vector<char>* out) {
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return !q.empty() || done; });
    if (q.empty()) return false;
    *out = std::move(q.front());
    q.pop_front();
    cv.notify_all();
    return true;
  }
  void finish(int err) {
    std::lock_guard<std::mutex> lk(m);
    done = true;
    error = err;
    cv.notify_all();
  }
};

// Streaming parse of any supported input (plain or gzip, FASTA or FASTQ):
// a producer thread decompresses 8 MB chunks while this thread parses
// complete records; the unconsumed tail of each buffer carries over.
// returns 0 ok, negative error
int parse(const char* path, Buffers* b) {
  init_lut();
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  gzbuffer(f, 1 << 20);

  ChunkQueue queue;
  std::thread producer([&] {
    constexpr size_t kChunk = 8u << 20;
    for (;;) {
      std::vector<char> chunk(kChunk);
      int n = gzread(f, chunk.data(), (unsigned)kChunk);
      if (n < 0) { queue.finish(-5); return; }
      if ((size_t)n < kChunk) {
        // a short read is EOF only if the stream ended cleanly: zlib
        // reports a truncated/corrupt gzip member via gzerror, NOT as a
        // negative gzread (silently parsing half a file is far worse
        // than failing)
        int errnum = Z_OK;
        gzerror(f, &errnum);
        if (errnum != Z_OK && errnum != Z_STREAM_END) {
          queue.finish(-5);
          return;
        }
      }
      if (n == 0) { queue.finish(0); return; }
      chunk.resize((size_t)n);
      if (!queue.push(std::move(chunk))) return;  // consumer bailed
      if ((size_t)n < kChunk) { queue.finish(0); return; }
    }
  });

  std::vector<char> buf;
  std::vector<char> chunk;
  int format = 0;  // 0 unknown, 1 fasta, 2 fastq
  int rc = 0;
  bool eof = false;
  b->offsets.push_back(0);
  for (;;) {
    if (!eof) {
      if (queue.pop(&chunk)) {
        buf.insert(buf.end(), chunk.begin(), chunk.end());
      } else {
        eof = true;
        if (queue.error) { rc = queue.error; break; }
      }
    }
    if (format == 0) {
      size_t i = 0;
      while (i < buf.size() && (buf[i] == '\n' || buf[i] == '\r')) ++i;
      if (i >= buf.size()) {
        buf.clear();
        if (eof) { rc = -2; break; }  // empty input
        continue;
      }
      if (buf[i] == '>') format = 1;
      else if (buf[i] == '@') format = 2;
      else { rc = -3; break; }
    }
    size_t used = (format == 1)
        ? parse_fasta_block(buf.data(), buf.size(), eof, b)
        : parse_fastq_block(buf.data(), buf.size(), eof, b);
    if (used > 0) buf.erase(buf.begin(), buf.begin() + used);
    if (eof) {
      if (!buf.empty()) rc = -4;  // truncated or malformed tail
      break;
    }
    if (used == 0) {
      // nothing consumed mid-stream: a record head that is not the
      // format's marker is malformed NOW — fail fast instead of
      // buffering the rest of the file until eof
      size_t i = 0;
      while (i < buf.size() && (buf[i] == '\n' || buf[i] == '\r')) ++i;
      if (i < buf.size() && buf[i] != (format == 1 ? '>' : '@')) {
        rc = -3;
        break;
      }
    }
  }
  queue.finish(rc);  // unblock the producer if we bailed early
  producer.join();
  gzclose(f);
  if (rc == 0 && b->offsets.size() == 1) rc = -2;  // no records
  return rc;
}

// ---- multi-threaded plain-FASTA parsing --------------------------------
//
// The whole file is read into one buffer, split at '>' record starts into
// near-equal segments, and each segment parses into its own Buffers in a
// worker thread; results concatenate in file order. Gzip and FASTQ inputs
// stay on the single-threaded streaming path (gzip cannot be split;
// FASTQ '@' is ambiguous with quality lines).

bool looks_plain_fasta(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t n = fread(magic, 1, 2, f);
  fclose(f);
  return n == 2 && magic[0] == '>' && !(magic[0] == 0x1f && magic[1] == 0x8b);
}

void parse_fasta_span(const char* data, size_t begin, size_t end, Buffers* b) {
  init_lut();
  size_t i = begin;
  while (i < end) {
    // at a '>' header
    size_t line_end = i;
    while (line_end < end && data[line_end] != '\n') ++line_end;
    // name = first token after '>'
    size_t ns = i + 1, ne = ns;
    while (ne < line_end && data[ne] != ' ' && data[ne] != '\t' &&
           data[ne] != '\r')
      ++ne;
    b->name_offsets.push_back(b->names.size());
    b->names.insert(b->names.end(), data + ns, data + ne);
    b->names.push_back('\0');
    // sequence lines until next '>' or end
    size_t base = b->codes.size();
    i = (line_end < end) ? line_end + 1 : end;
    while (i < end && data[i] != '>') {
      size_t le = i;
      while (le < end && data[le] != '\n') ++le;
      size_t stop = le;
      while (stop > i && (data[stop - 1] == '\r')) --stop;
      size_t cur = b->codes.size();
      b->codes.resize(cur + (stop - i));
      uint8_t* dst = b->codes.data() + cur;
      for (size_t j = i; j < stop; ++j) dst[j - i] = g_lut[(unsigned char)data[j]];
      i = (le < end) ? le + 1 : end;
    }
    (void)base;
    b->offsets.push_back(b->codes.size());
  }
}

// Parse plain-FASTA records inside byte range [lo, hi) of the file. lo
// must be 0 or an exact record start ('>' following '\n'); hi an exact
// record start or EOF — multi-host ranks get these from fastx_scan_range,
// so each rank reads ONLY its ~1/ranks share of the input (SURVEY §2.8
// host-side sharded I/O; the full-reparse fallback was O(input x ranks)).
int parse_mt_range(const char* path, uint64_t lo, uint64_t hi, int threads,
                   Buffers* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  uint64_t fsz = (uint64_t)ftell(f);
  if (hi > fsz) hi = fsz;
  if (lo >= hi) {
    fclose(f);
    return -2;
  }
  uint64_t sz = hi - lo;
  fseek(f, (long)lo, SEEK_SET);
  std::vector<char> data((size_t)sz);
  if (fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    return -5;
  }
  fclose(f);
  if (sz == 0) return -2;

  // segment boundaries at '\n>' (record starts)
  std::vector<size_t> starts;
  starts.push_back(0);
  size_t target = (size_t)sz / (size_t)threads;
  for (int t = 1; t < threads; ++t) {
    size_t pos = (size_t)t * target;
    while (pos + 1 < (size_t)sz &&
           !(data[pos] == '\n' && data[pos + 1] == '>'))
      ++pos;
    if (pos + 1 < (size_t)sz) starts.push_back(pos + 1);
  }
  starts.push_back((size_t)sz);

  size_t n_seg = starts.size() - 1;
  std::vector<Buffers> parts(n_seg);
  std::vector<std::thread> pool;
  for (size_t s = 0; s < n_seg; ++s) {
    pool.emplace_back([&, s]() {
      // skip leading whitespace/newlines in segment 0
      size_t begin = starts[s];
      while (begin < starts[s + 1] && data[begin] != '>') ++begin;
      parts[s].offsets.clear();  // span parser appends per-record ends only
      parse_fasta_span(data.data(), begin, starts[s + 1], &parts[s]);
    });
  }
  for (auto& th : pool) th.join();

  // concatenate in order, rebasing offsets
  out->offsets.push_back(0);
  for (auto& p : parts) {
    uint64_t code_base = out->codes.size();
    uint64_t name_base = out->names.size();
    out->codes.insert(out->codes.end(), p.codes.begin(), p.codes.end());
    out->names.insert(out->names.end(), p.names.begin(), p.names.end());
    for (uint64_t off : p.offsets) out->offsets.push_back(code_base + off);
    for (uint64_t off : p.name_offsets)
      out->name_offsets.push_back(name_base + off);
  }
  return 0;
}

int parse_mt(const char* path, int threads, Buffers* out) {
  return parse_mt_range(path, 0, ~0ULL, threads, out);
}

}  // namespace

extern "C" {

struct FastxParsed {
  uint8_t* codes;
  uint64_t* offsets;       // n_reads + 1
  char* names;             // concatenated, NUL-separated
  uint64_t* name_offsets;  // n_reads
  uint64_t n_reads;
  uint64_t total_bases;
  uint64_t names_bytes;
};

// Returns 0 on success; fills *out. Free with fastx_free.
// threads > 1 uses the segmented parallel parser for plain FASTA inputs
// (gzip/FASTQ fall back to the streaming parser).
int fastx_parse_threads(const char* path, int threads, FastxParsed* out) {
  Buffers b;
  int rc;
  if (threads > 1 && looks_plain_fasta(path)) {
    rc = parse_mt(path, threads, &b);
  } else {
    rc = parse(path, &b);
  }
  if (rc != 0) return rc;
  out->n_reads = b.offsets.size() - 1;
  out->total_bases = b.codes.size();
  out->names_bytes = b.names.size();

  out->codes = (uint8_t*)malloc(b.codes.size() ? b.codes.size() : 1);
  memcpy(out->codes, b.codes.data(), b.codes.size());
  out->offsets = (uint64_t*)malloc(b.offsets.size() * sizeof(uint64_t));
  memcpy(out->offsets, b.offsets.data(), b.offsets.size() * sizeof(uint64_t));
  out->names = (char*)malloc(b.names.size() ? b.names.size() : 1);
  memcpy(out->names, b.names.data(), b.names.size());
  out->name_offsets =
      (uint64_t*)malloc((out->n_reads ? out->n_reads : 1) * sizeof(uint64_t));
  memcpy(out->name_offsets, b.name_offsets.data(),
         out->n_reads * sizeof(uint64_t));
  return 0;
}

int fastx_parse(const char* path, FastxParsed* out) {
  return fastx_parse_threads(path, 1, out);
}

// Fill a padded bucket matrix: out[i, :len_i] = codes[offsets[rows[i]] ...],
// rest untouched (caller pre-fills with the INVALID code). Plain memcpy per
// read — the host VMs this runs on have poor vectorized-numpy throughput.
void fastx_fill_bucket(const uint8_t* codes, const uint64_t* offsets,
                       const int32_t* rows, uint64_t n_rows,
                       uint64_t bucket_len, uint8_t* out) {
  for (uint64_t i = 0; i < n_rows; ++i) {
    uint64_t r = (uint64_t)rows[i];
    uint64_t len = offsets[r + 1] - offsets[r];
    if (len > bucket_len) len = bucket_len;
    memcpy(out + i * bucket_len, codes + offsets[r], len);
  }
}

// Fill a 2-bit-packed bucket: out_packed[i] holds ceil(bucket_len/4) bytes
// (4 bases each, little-endian within the byte: base j in bits 2*(j%4)),
// out_valid holds ceil(bucket_len/8) validity bits (bit j%8 of byte j/8).
// Padding/invalid bases pack as A with a cleared validity bit. Shrinks the
// host->device upload 4x (plus 1/8 for the mask).
// Returns the number of invalid (non-ACGT) bases inside the filled rows:
// zero means every row's validity is a pure length prefix, so the device
// upload can ride per-row lengths instead of the valid-bits plane (and the
// host skips a popcount re-derivation per run).
int64_t fastx_fill_bucket_packed(const uint8_t* codes, const uint64_t* offsets,
                                 const int32_t* rows, uint64_t n_rows,
                                 uint64_t bucket_len, uint8_t* out_packed,
                                 uint8_t* out_valid) {
  uint64_t packed_stride = (bucket_len + 3) / 4;
  uint64_t valid_stride = (bucket_len + 7) / 8;
  int64_t n_invalid = 0;
  for (uint64_t i = 0; i < n_rows; ++i) {
    uint64_t r = (uint64_t)rows[i];
    uint64_t len = offsets[r + 1] - offsets[r];
    if (len > bucket_len) len = bucket_len;
    const uint8_t* src = codes + offsets[r];
    uint8_t* pk = out_packed + i * packed_stride;
    uint8_t* vd = out_valid + i * valid_stride;
    for (uint64_t j = 0; j < len; ++j) {
      uint8_t c = src[j];
      if (c < 4) {
        pk[j >> 2] |= (uint8_t)(c << ((j & 3) * 2));
        vd[j >> 3] |= (uint8_t)(1u << (j & 7));
      } else {
        // invalid: leave 0 bits (A) with validity 0
        ++n_invalid;
      }
    }
  }
  return n_invalid;
}

// One formatted row into dst (caller guarantees capacity); returns bytes.
// snprintf("%.9g") matches the python oracle's f"{x:.9g}" byte-for-byte
// (test_native_io); names/ranks are appended with memcpy + manual itoa —
// fprintf's per-call overhead (locale, vfprintf parse, stream lock)
// dominated the output stage.
inline size_t format_row(char* dst, const char* qname, size_t qlen, char qo,
                         const char* tname, size_t tlen, char to,
                         uint64_t rank, double d) {
  char* p = dst;
  memcpy(p, qname, qlen);
  p += qlen;
  *p++ = '\t';
  *p++ = qo;
  *p++ = '\t';
  memcpy(p, tname, tlen);
  p += tlen;
  *p++ = '\t';
  *p++ = to;
  *p++ = '\t';
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + rank % 10);
    rank /= 10;
  } while (rank);
  while (n) *p++ = tmp[--n];
  *p++ = '\t';
  // to_chars(general, 9) == printf %.9g by [charconv.to.chars] (and
  // byte-checked against the python oracle's f"{x:.9g}" in tests) at a
  // fraction of snprintf's cost
  auto res = std::to_chars(p, p + 32, d, std::chars_format::general, 9);
  p = res.ptr;
  *p++ = '\n';
  return (size_t)(p - dst);
}

// Overlap writer over the raw neighbor matrices: skips self rows
// (t == global row index) and negative/unset targets internally, so the
// host does zero numpy row filtering. Rows are formatted into per-thread
// memory buffers and fwritten in order. row_offset shifts local matrix row
// q to global embedding row row_offset+q (multi-host ranks write only
// their own query rows; names stay globally indexed).
int64_t fastx_write_overlaps_matrix(const char* path, const char* names,
                                    const uint64_t* name_offsets,
                                    uint64_t n_names, const int32_t* idx,
                                    const float* dist, uint64_t n_rows,
                                    uint64_t k, uint64_t row_offset) {
  // name lengths once (strlen per row would rescan)
  std::vector<uint32_t> nlen(n_names);
  size_t max_name = 1;
  for (uint64_t i = 0; i < n_names; ++i) {
    nlen[i] = (uint32_t)strlen(names + name_offsets[i]);
    if (nlen[i] > max_name) max_name = nlen[i];
  }
  for (uint64_t q = 0; q < n_rows; ++q) {
    if (((row_offset + q) >> 1) >= n_names) return -2;
    for (uint64_t r = 0; r < k; ++r) {
      int32_t t = idx[q * k + r];
      if (t >= 0 && (uint64_t)(t >> 1) >= n_names) return -2;
    }
  }
  // Band-pipelined formatting (chr1-scale fix: the old one-buffer-per-
  // thread scheme allocated rows*~70 B up front — 2.5 GB at 36M rows —
  // and the first-touch page faults on this throttled host dominated the
  // stage at ~400-475 ns/row). Rows are split into fixed bands; workers
  // format bands round-robin into a SMALL reused buffer ring while the
  // main thread fwrites completed bands in order. Peak memory is
  // RING * band bytes regardless of table size, and after the first lap
  // every buffer page is warm.
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  const uint64_t BAND = 2048;
  const unsigned RING = 2 * n_threads + 2;
  uint64_t n_bands = (n_rows + BAND - 1) / BAND;
  std::vector<std::string> ring(RING);
  std::vector<int64_t> band_count(RING, 0);
  // slot s may hold band b only when every band below b - (RING - 1) is
  // flushed; state: next band each slot may accept (producer side) and a
  // ready flag (consumer side)
  std::vector<int64_t> slot_ready(RING, -1);  // band id formatted, -1 free
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<uint64_t> next_band{0};
  std::atomic<uint64_t> flushed{0};  // bands fully written to the file
  std::atomic<bool> failed{false};

  auto worker = [&]() {
    size_t row_cap = 2 * max_name + 64;
    std::vector<char> row(row_cap);
    for (;;) {
      uint64_t b = next_band.fetch_add(1);
      if (b >= n_bands || failed.load()) return;
      unsigned s = (unsigned)(b % RING);
      {
        // wait until the slot's previous occupant (band b - RING) is on
        // disk
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return failed.load() || b < RING || flushed.load() >= b - RING + 1;
        });
        if (failed.load()) return;
      }
      std::string& out = ring[s];
      out.clear();
      out.reserve(BAND * k * (2 * max_name + 48));
      int64_t written = 0;
      uint64_t lo = b * BAND, hi = lo + BAND;
      if (hi > n_rows) hi = n_rows;
      for (uint64_t q = lo; q < hi; ++q) {
        uint64_t g = row_offset + q;  // global embedding row
        const char* qname = names + name_offsets[g >> 1];
        size_t qlen = nlen[g >> 1];
        char qo = (g & 1) ? '-' : '+';
        for (uint64_t r = 0; r < k; ++r) {
          int32_t t = idx[q * k + r];
          if (t < 0 || (uint64_t)t == g) continue;
          size_t n = format_row(
              row.data(), qname, qlen, qo, names + name_offsets[t >> 1],
              nlen[t >> 1], (t & 1) ? '-' : '+', r,
              (double)dist[q * k + r]);
          out.append(row.data(), n);
          ++written;
        }
      }
      band_count[s] = written;
      {
        std::lock_guard<std::mutex> lk(mu);
        slot_ready[s] = (int64_t)b;
      }
      cv_ready.notify_all();
    }
  };

  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  std::vector<std::thread> workers;
  for (unsigned w = 0; w < n_threads; ++w) workers.emplace_back(worker);
  int64_t total = 0;
  int64_t rc = 0;
  for (uint64_t b = 0; b < n_bands; ++b) {
    unsigned s = (unsigned)(b % RING);
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return slot_ready[s] == (int64_t)b; });
    }
    std::string& out = ring[s];
    if (!out.empty() &&
        fwrite_chunked(out.data(), out.size(), f) != out.size()) {
      failed.store(true);
      rc = -3;
      cv_free.notify_all();
      break;
    }
    total += band_count[s];
    {
      std::lock_guard<std::mutex> lk(mu);
      slot_ready[s] = -1;
      flushed.store(b + 1);
    }
    cv_free.notify_all();
  }
  cv_free.notify_all();
  for (auto& t : workers) t.join();
  fclose(f);
  return rc < 0 ? rc : total;
}

// Append overlap rows to an opened-for-write FILE (path), reference TSV
// contract (6 columns; orientation = row parity). Returns rows written or
// negative errno-style code. Python-level writers on the throttled host
// VMs cost 3-25 s per million rows; this loop is I/O-bound.
int64_t fastx_write_overlaps(const char* path, const char* names,
                             const uint64_t* name_offsets, uint64_t n_names,
                             const int32_t* q_rows, const int32_t* t_rows,
                             const int32_t* ranks, const float* dists,
                             uint64_t n_rows) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  static char buf[1 << 20];
  setvbuf(f, buf, _IOFBF, sizeof(buf));
  for (uint64_t i = 0; i < n_rows; ++i) {
    uint32_t q = (uint32_t)q_rows[i], t = (uint32_t)t_rows[i];
    uint64_t qn = q >> 1, tn = t >> 1;
    if (qn >= n_names || tn >= n_names) {
      fclose(f);
      return -2;
    }
    fprintf(f, "%s\t%c\t%s\t%c\t%d\t%.9g\n", names + name_offsets[qn],
            (q & 1) ? '-' : '+', names + name_offsets[tn],
            (t & 1) ? '-' : '+', ranks[i], (double)dists[i]);
  }
  fclose(f);
  return (int64_t)n_rows;
}

// Parse only records whose '>' lies at byte lo (exactly) through byte hi
// (an exact record start or EOF). Plain FASTA only: gzip cannot be
// random-accessed and FASTQ '@' is ambiguous — callers detect via
// fastx_is_plain_fasta and fall back to the full parse. rc -6 = not plain.
int fastx_parse_range(const char* path, uint64_t lo, uint64_t hi,
                      int threads, FastxParsed* out) {
  if (!looks_plain_fasta(path)) return -6;
  Buffers b;
  int rc = parse_mt_range(path, lo, hi, threads < 1 ? 1 : threads, &b);
  if (rc != 0) return rc;
  out->n_reads = b.offsets.size() - 1;
  out->total_bases = b.codes.size();
  out->names_bytes = b.names.size();
  out->codes = (uint8_t*)malloc(b.codes.size() ? b.codes.size() : 1);
  memcpy(out->codes, b.codes.data(), b.codes.size());
  out->offsets = (uint64_t*)malloc(b.offsets.size() * sizeof(uint64_t));
  memcpy(out->offsets, b.offsets.data(), b.offsets.size() * sizeof(uint64_t));
  out->names = (char*)malloc(b.names.size() ? b.names.size() : 1);
  memcpy(out->names, b.names.data(), b.names.size());
  out->name_offsets =
      (uint64_t*)malloc((out->n_reads ? out->n_reads : 1) * sizeof(uint64_t));
  memcpy(out->name_offsets, b.name_offsets.data(),
         out->n_reads * sizeof(uint64_t));
  return 0;
}

int fastx_is_plain_fasta(const char* path) {
  return looks_plain_fasta(path) ? 1 : 0;
}

struct FastxScan {
  uint64_t* rec_offsets;   // absolute byte offset of each record's '>'
  char* names;             // concatenated, NUL-separated
  uint64_t* name_offsets;  // n_records offsets into names
  uint64_t n_records;
  uint64_t names_bytes;
};

// Cheap record-boundary scan over byte range [lo, hi): offsets + names of
// every record STARTING in the range, no base decoding. Each multi-host
// rank scans 1/ranks of the file; offsets+names allgather between hosts (they
// are ~1% of the input bytes), after which every rank knows the exact
// byte range of any record interval for fastx_parse_range. rc -6 = not
// plain FASTA.
int fastx_scan_range(const char* path, uint64_t lo, uint64_t hi,
                     FastxScan* out) {
  if (!looks_plain_fasta(path)) return -6;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  uint64_t fsz = (uint64_t)ftell(f);
  if (hi > fsz) hi = fsz;
  if (lo > hi) lo = hi;
  // read [base, hi): one byte before lo so "record start" ('>' after
  // '\n') is decidable at lo itself
  uint64_t base = lo > 0 ? lo - 1 : 0;
  std::vector<char> data((size_t)(hi - base));
  fseek(f, (long)base, SEEK_SET);
  if (fread(data.data(), 1, data.size(), f) != data.size()) {
    fclose(f);
    return -5;
  }
  std::vector<uint64_t> offs;
  std::vector<char> names;
  std::vector<uint64_t> name_offs;
  size_t i = (lo > 0) ? 1 : 0;  // index of byte lo within data
  while (i < data.size()) {
    bool at_start = (base + i == 0) ? data[i] == '>'
                                    : (data[i] == '>' && data[i - 1] == '\n');
    if (!at_start) {
      ++i;
      continue;
    }
    offs.push_back(base + i);
    // name = first token after '>'; the line may extend past hi — stream
    // extra bytes until its newline
    size_t ns = i + 1, ne = ns;
    std::string tail;
    const char* line = data.data();
    size_t limit = data.size();
    while (true) {
      while (ne < limit && line[ne] != '\n' && line[ne] != ' ' &&
             line[ne] != '\t' && line[ne] != '\r')
        ++ne;
      if (ne < limit || base + limit >= fsz) break;
      // token continues past the buffer: pull the rest of the line in
      tail.assign(data.begin() + ns, data.end());
      char chunk[65536];
      uint64_t pos = base + data.size();
      bool done = false;
      fseek(f, (long)pos, SEEK_SET);
      while (!done) {
        size_t got = fread(chunk, 1, sizeof(chunk), f);
        if (!got) break;
        for (size_t j = 0; j < got; ++j) {
          char c = chunk[j];
          if (c == '\n' || c == ' ' || c == '\t' || c == '\r') {
            done = true;
            break;
          }
          tail.push_back(c);
        }
        if (pos + got >= fsz) break;
        pos += got;
      }
      line = tail.data();
      ns = 0;
      ne = tail.size();
      limit = tail.size();
      break;
    }
    name_offs.push_back(names.size());
    names.insert(names.end(), line + ns, line + ne);
    names.push_back('\0');
    // skip to next line inside the buffer
    while (i < data.size() && data[i] != '\n') ++i;
    ++i;
  }
  fclose(f);
  out->n_records = offs.size();
  out->names_bytes = names.size();
  out->rec_offsets = (uint64_t*)malloc((offs.size() ? offs.size() : 1) *
                                       sizeof(uint64_t));
  memcpy(out->rec_offsets, offs.data(), offs.size() * sizeof(uint64_t));
  out->names = (char*)malloc(names.size() ? names.size() : 1);
  memcpy(out->names, names.data(), names.size());
  out->name_offsets = (uint64_t*)malloc(
      (name_offs.size() ? name_offs.size() : 1) * sizeof(uint64_t));
  memcpy(out->name_offsets, name_offs.data(),
         name_offs.size() * sizeof(uint64_t));
  return 0;
}

void fastx_scan_free(FastxScan* s) {
  free(s->rec_offsets);
  free(s->names);
  free(s->name_offsets);
  s->rec_offsets = nullptr;
  s->names = nullptr;
  s->name_offsets = nullptr;
}

void fastx_free(FastxParsed* p) {
  free(p->codes);
  free(p->offsets);
  free(p->names);
  free(p->name_offsets);
  p->codes = nullptr;
  p->offsets = nullptr;
  p->names = nullptr;
  p->name_offsets = nullptr;
}

}  // extern "C"
