// Native FASTA/MSA ingest for gaussdca_tpu_torch.
//
// The host-side parser of gaussdca_tpu_torch/io/fasta.py (the DCAUtils
// read_fasta_alignment contract): transparent gzip via zlib (gzopen reads
// plain files too), insert-state removal (lowercase + '.'), letter->state
// tokenization (20 amino acids -> 1..20, everything else -> 21), inclusive
// gap-fraction filtering, ragged-length detection.
//
// The JAX package's native/fasta_native.cpp from its first #include on,
// byte for byte (tests/test_torch_native_io.py holds the two equal), so
// the port builds the parser from its own sources. A plain C ABI for
// ctypes, loaded by gaussdca_tpu_torch/io/native.py, which builds it with
// g++ through ops/_build.py: first with -ldeflate -lz, then with
// -DGDCA_NO_LIBDEFLATE -lz where libdeflate is absent.
//
// Decompression: gzip inflation dominates ingest wall, so gzip members are
// inflated with libdeflate's whole-buffer decoder when available, and any
// libdeflate failure (unusual framing, trailing garbage) falls back to
// zlib's tolerant streaming gzread.

#include <zlib.h>

#if !defined(GDCA_NO_LIBDEFLATE) && defined(__has_include)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define GDCA_HAVE_LIBDEFLATE 1
#endif
#endif

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Msa {
  int64_t m = 0;
  int64_t n = 0;
  int32_t n_dropped = 0;
  int32_t q = 0;
  std::vector<uint8_t> tokens;        // m*n row-major
  std::vector<std::string> headers;   // kept sequences only
  std::string headers_blob;           // lazy '\n'-joined cache
  std::string error;                  // non-empty => parse failed
};

constexpr uint8_t kGapState = 21;

struct Luts {
  uint8_t state[256];
  bool insert[256];
  Luts() {
    for (int i = 0; i < 256; ++i) {
      state[i] = kGapState;
      insert[i] = false;
    }
    const char* aa = "ACDEFGHIKLMNPQRSTVWY";
    for (int i = 0; aa[i]; ++i) state[(uint8_t)aa[i]] = (uint8_t)(i + 1);
    for (int c = 'a'; c <= 'z'; ++c) insert[c] = true;
    insert[(uint8_t)'.'] = true;
  }
};
const Luts kLut;

bool read_all_zlib(const char* path, std::vector<char>* out,
                   std::string* err) {
  gzFile f = gzopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open file ") + path;
    return false;
  }
  (void)gzbuffer(f, 1 << 20);
  char buf[1 << 20];
  int got;
  while ((got = gzread(f, buf, sizeof buf)) > 0)
    out->insert(out->end(), buf, buf + got);
  bool ok = got == 0;
  if (!ok) {
    int zerr = 0;
    const char* msg = gzerror(f, &zerr);
    *err = std::string("error reading ") + path + ": " +
           (msg ? msg : "gzread failed");
  }
  gzclose(f);
  return ok;
}

#ifdef GDCA_HAVE_LIBDEFLATE
// Whole-buffer gzip decode, looping over concatenated members. Returns
// false on ANY decode error (caller falls back to zlib streaming).
bool inflate_libdeflate(const std::vector<char>& in,
                        std::vector<char>* out) {
  const size_t sz = in.size();
  // last member's ISIZE (mod 2^32) — exact for the common single-member
  // file; the growth loop below covers multi-member and wrapped sizes
  size_t guess = ((size_t)(uint8_t)in[sz - 4]) |
                 ((size_t)(uint8_t)in[sz - 3] << 8) |
                 ((size_t)(uint8_t)in[sz - 2] << 16) |
                 ((size_t)(uint8_t)in[sz - 1] << 24);
  if (guess < sz) guess = sz * 4;
  libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  if (!d) return false;
  // resize failures must report false, not throw: the ISIZE guess is
  // untrusted input (trailing garbage reads as a ~4 GB size), and the
  // whole-buffer path's contract is "any failure -> zlib fallback" —
  // a bad_alloc escaping here would fail files zlib parses fine
  try {
    out->resize(guess);
  } catch (const std::bad_alloc&) {
    libdeflate_free_decompressor(d);
    return false;
  }
  size_t in_pos = 0, out_pos = 0;
  bool ok = true;
  while (in_pos < sz) {
    size_t in_used = 0, out_used = 0;
    libdeflate_result r = libdeflate_gzip_decompress_ex(
        d, in.data() + in_pos, sz - in_pos, out->data() + out_pos,
        out->size() - out_pos, &in_used, &out_used);
    if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
      try {
        out->resize(out->size() * 2 + (1 << 20));
      } catch (const std::bad_alloc&) {
        ok = false;
        break;
      }
      continue;
    }
    if (r != LIBDEFLATE_SUCCESS) {  // bad data / trailing garbage:
      ok = false;                   // let zlib's tolerant reader decide
      break;
    }
    in_pos += in_used;
    out_pos += out_used;
  }
  libdeflate_free_decompressor(d);
  if (ok) out->resize(out_pos);
  return ok;
}
#endif

bool read_all(const char* path, std::vector<char>* out, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open file ") + path;
    return false;
  }
  std::vector<char> raw;
  if (std::fseek(f, 0, SEEK_END) == 0) {
    long sz = std::ftell(f);
    if (sz > 0) raw.reserve((size_t)sz);
    std::fseek(f, 0, SEEK_SET);
  }
  char buf[1 << 20];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f)) > 0)
    raw.insert(raw.end(), buf, buf + got);
  bool rd_ok = !std::ferror(f);
  std::fclose(f);
  if (!rd_ok) {
    *err = std::string("error reading ") + path;
    return false;
  }
  const bool is_gzip = raw.size() >= 2 &&
                       (uint8_t)raw[0] == 0x1f && (uint8_t)raw[1] == 0x8b;
  if (!is_gzip) {       // plain FASTA: no decompression pass at all
    *out = std::move(raw);
    return true;
  }
#ifdef GDCA_HAVE_LIBDEFLATE
  // 18 bytes = minimal complete member (header + trailer with ISIZE)
  if (raw.size() >= 18 && inflate_libdeflate(raw, out)) return true;
  out->clear();
#endif
  return read_all_zlib(path, out, err);
}

// One record being assembled — tokenized in a SINGLE pass over the
// sequence bytes (insert filter + gap count + state LUT + running max
// fused; the old filter-then-rescan layout cost ~3 passes per byte and
// dominated ingest wall once libdeflate shrank the inflate phase).
struct Record {
  std::string header;
  std::vector<uint8_t> tok;   // states 1..21, inserts already skipped
  int64_t ngaps = 0;          // '-' characters only (not B/J/O/U/X/Z)
  uint8_t qmax = 0;
  void clear() {
    header.clear();
    tok.clear();
    ngaps = 0;
    qmax = 0;
  }
};

void finish_record(Msa* msa, Record* rec, double max_gap_fraction,
                   const char* path) {
  if (!msa->error.empty()) return;
  if (msa->n == 0 && msa->m == 0 && msa->n_dropped == 0) {
    msa->n = (int64_t)rec->tok.size();
    if (msa->n == 0) {
      msa->error = std::string("invalid FASTA file ") + path +
                   ": empty first sequence";
      return;
    }
  } else if ((int64_t)rec->tok.size() != msa->n) {
    msa->error = std::string("invalid FASTA file ") + path +
                 ": sequences have inconsistent lengths (" +
                 std::to_string(rec->tok.size()) + " != " +
                 std::to_string(msa->n) + ")";
    return;
  }
  if ((double)rec->ngaps / (double)msa->n > max_gap_fraction) {
    ++msa->n_dropped;
  } else {
    msa->tokens.insert(msa->tokens.end(), rec->tok.begin(),
                       rec->tok.end());
    if (rec->qmax > msa->q) msa->q = rec->qmax;
    msa->headers.push_back(std::move(rec->header));
    ++msa->m;
  }
  rec->clear();
}

Msa* parse(const char* path, double max_gap_fraction) {
  auto msa = new Msa();
  std::vector<char> data;
  if (!read_all(path, &data, &msa->error)) return msa;

  Record rec;
  bool in_record = false;
  bool any_record = false;

  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end && msa->error.empty()) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    // strip trailing CR / whitespace, leading whitespace
    const char* b = p;
    const char* e = le;
    while (b < e && (unsigned char)b[0] <= ' ') ++b;
    while (e > b && (unsigned char)e[-1] <= ' ') --e;
    if (b < e) {
      if (*b == '>') {
        if (in_record)
          finish_record(msa, &rec, max_gap_fraction, path);
        rec.header.assign(b + 1, (size_t)(e - b - 1));
        in_record = true;
        any_record = true;
      } else if (!in_record) {
        msa->error = std::string("invalid FASTA file ") + path +
                     ": sequence data before the first header";
      } else {
        // pointer writes into a line-sized upper bound: no per-char
        // capacity check (the loop runs once per residue of the MSA)
        const size_t base = rec.tok.size();
        rec.tok.resize(base + (size_t)(e - b));
        uint8_t* w = rec.tok.data() + base;
        int64_t ngaps = rec.ngaps;
        uint8_t qmax = rec.qmax;
        for (const char* c = b; c < e; ++c) {
          uint8_t u = (uint8_t)*c;
          if (kLut.insert[u]) continue;       // lowercase / '.'
          uint8_t s = kLut.state[u];
          *w++ = s;
          ngaps += (u == (uint8_t)'-');
          if (s > qmax) qmax = s;
        }
        rec.tok.resize((size_t)(w - rec.tok.data()));
        rec.ngaps = ngaps;
        rec.qmax = qmax;
      }
    }
    p = nl ? nl + 1 : end;
  }
  if (in_record && msa->error.empty())
    finish_record(msa, &rec, max_gap_fraction, path);
  if (msa->error.empty() && !any_record)
    msa->error = std::string("invalid FASTA file ") + path +
                 ": no sequences found";
  if (msa->error.empty() && msa->m == 0)
    msa->error = std::string("invalid FASTA file ") + path +
                 ": all sequences exceed max_gap_fraction=" +
                 std::to_string(max_gap_fraction);
  return msa;
}

}  // namespace

extern "C" {

void* gdca_parse(const char* path, double max_gap_fraction) {
  try {
    return parse(path, max_gap_fraction);
  } catch (const std::bad_alloc&) {
    // a corrupt ISIZE or a pathological file must surface as a parse
    // error through the ctypes boundary, not a process abort
    auto* msa = new (std::nothrow) Msa();
    if (msa) msa->error = std::string("out of memory parsing ") + path;
    return msa;
  } catch (...) {
    auto* msa = new (std::nothrow) Msa();
    if (msa) msa->error = std::string("internal error parsing ") + path;
    return msa;
  }
}

const char* gdca_msa_error(void* h) {
  auto* msa = (Msa*)h;
  return msa->error.empty() ? nullptr : msa->error.c_str();
}

int64_t gdca_msa_m(void* h) { return ((Msa*)h)->m; }
int64_t gdca_msa_n(void* h) { return ((Msa*)h)->n; }
int32_t gdca_msa_q(void* h) { return ((Msa*)h)->q; }
int32_t gdca_msa_dropped(void* h) { return ((Msa*)h)->n_dropped; }

const uint8_t* gdca_msa_tokens(void* h) { return ((Msa*)h)->tokens.data(); }

const char* gdca_msa_header(void* h, int64_t i) {
  auto* msa = (Msa*)h;
  if (i < 0 || i >= (int64_t)msa->headers.size()) return nullptr;
  return msa->headers[(size_t)i].c_str();
}

// All headers '\n'-joined (with a trailing '\n') in ONE ctypes call —
// 100k per-header calls + decodes cost ~0.12 s Python-side. Headers
// cannot contain '\n' (they are single lines by construction); a NUL
// byte inside a header truncates the blob at the ctypes boundary, so
// the Python loader falls back to per-header calls when the entry
// count mismatches.
const char* gdca_msa_headers_blob(void* h) {
  auto* msa = (Msa*)h;
  if (msa->headers_blob.empty() && !msa->headers.empty()) {
    size_t total = 0;
    for (const auto& s : msa->headers) total += s.size() + 1;
    try {
      msa->headers_blob.reserve(total);
      for (const auto& s : msa->headers) {
        msa->headers_blob += s;
        msa->headers_blob += '\n';
      }
    } catch (const std::bad_alloc&) {
      msa->headers_blob.clear();
      return nullptr;  // loader falls back to per-header calls
    }
  }
  return msa->headers_blob.c_str();
}

void gdca_msa_free(void* h) { delete (Msa*)h; }

}  // extern "C"
