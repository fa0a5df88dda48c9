// Parallel zlib-stream compressor for PNG IDAT payloads.
//
// The reference overlaps host-side PNG encoding with rendering by spawning
// one encoder thread per frame (src/bin/main.rs:507-516); single-stream
// deflate is still the per-frame bottleneck at ~40 MB/s. This cuts the
// filtered scanline stream into fixed 256 KB stripes, deflates them as
// independent raw-deflate segments flushed at byte boundaries
// (Z_FULL_FLUSH), and stitches them into one spec-valid zlib stream
// (pigz's trick):
//
//   [0x78 0x9C] [stripe 0 raw deflate, full-flush] ... [last stripe, finish]
//   [adler32 of the whole input, via adler32_combine]
//
// A render's light sits in a few rows, so stripes differ several times in
// cost: workers pull the next stripe index from a shared counter until none
// is left, and the call ends with the total work spread over the cores
// rather than with the densest stripe. Each stripe but the first is primed
// with the 32 KB of input before it (deflateSetDictionary), so its matches
// may reach back across the boundary as one stream's would. The stripe size
// depends on nothing but `n`, so the stream's bytes do not depend on the
// thread count.
//
// Host code, not a device kernel: built with g++ at first use by
// strange_attractor_tpu_torch/utils/native.py (into build/torch_kernels/);
// the stdlib writer is the fallback. The JAX package's
// strange_attractor_tpu/native/fastdeflate.cpp is the design this grew from.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

constexpr long kStripe = 1L << 18;  // 256 KB of input a stripe
constexpr long kWindow = 1L << 15;  // deflate's 32 KB window: the priming

extern "C" {

// The stripes fastdeflate_zlib cuts `n` >= 0 bytes into.
long fastdeflate_stripes(long n) { return n > kStripe ? (n + kStripe - 1) / kStripe : 1; }

// Compress `n` bytes of `data` into a complete zlib stream in `out` on up
// to `threads` workers. Returns the stream length, or -1 on error /
// insufficient `out_cap` (callers should provide n + (n >> 9) + 64 + 32 per
// stripe: see utils/native.py).
long fastdeflate_zlib(const uint8_t* data, long n, int level, int threads,
                      uint8_t* out, long out_cap) {
  if (n < 0 || level < 1 || level > 9) return -1;
  if (threads < 1) threads = 1;
  if (threads > 64) threads = 64;
  const int t = (int)fastdeflate_stripes(n);
  if (threads > t) threads = t;

  std::vector<std::vector<uint8_t>> parts(t);
  std::vector<unsigned long> adlers(t);
  std::vector<int> errs(t, 0);
  std::atomic<int> next{0};

  auto deflate_stripe = [&](int i) {
    long off = (long)i * kStripe;
    long len = n - off < kStripe ? n - off : kStripe;
    bool last = (i == t - 1);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    // raw deflate (negative windowBits): we add the zlib wrapper ourselves;
    // a fresh stream a stripe, so no stripe sees what a worker did before
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 9, Z_DEFAULT_STRATEGY) != Z_OK) {
      errs[i] = 1;
      return;
    }
    if (off > 0) {
      long dict = off < kWindow ? off : kWindow;
      if (deflateSetDictionary(&zs, data + off - dict, (uInt)dict) != Z_OK) {
        deflateEnd(&zs);
        errs[i] = 1;
        return;
      }
    }
    uLong cap = deflateBound(&zs, (uLong)len) + 64;
    parts[i].resize(cap);
    zs.next_in = const_cast<Bytef*>(data + off);
    zs.avail_in = (uInt)len;
    zs.next_out = parts[i].data();
    zs.avail_out = (uInt)cap;
    int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
    // Z_OK is also what deflate returns when avail_out ran dry with input
    // left over (deflateBound is only documented for single-shot usage):
    // without the avail_in check a too-small buffer would silently drop
    // part of a stripe and stitch a corrupt stream instead of failing
    if ((last && rc != Z_STREAM_END) ||
        (!last && (rc != Z_OK || zs.avail_in != 0)))
      errs[i] = 1;
    parts[i].resize(cap - zs.avail_out);
    deflateEnd(&zs);
    adlers[i] = adler32(adler32(0L, Z_NULL, 0), data + off, (uInt)len);
  };
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < t; i = next.fetch_add(1)) deflate_stripe(i);
  };

  std::vector<std::thread> pool;
  for (int w = 1; w < threads; ++w) pool.emplace_back(work);
  work();  // the calling thread is one of the workers
  for (auto& th : pool) th.join();
  for (int i = 0; i < t; ++i)
    if (errs[i]) return -1;

  long total = 2 + 4;  // zlib header + adler trailer
  for (auto& p : parts) total += (long)p.size();
  if (total > out_cap) return -1;

  long pos = 0;
  out[pos++] = 0x78;  // CMF: deflate, 32k window
  out[pos++] = 0x9C;  // FLG: default level preset (zlib.compress's at 6), check bits valid
  for (auto& p : parts) {
    std::memcpy(out + pos, p.data(), p.size());
    pos += (long)p.size();
  }
  unsigned long ad = adlers[0];
  for (int i = 1; i < t; ++i) {
    long len = n - (long)i * kStripe;
    if (len > kStripe) len = kStripe;
    ad = adler32_combine(ad, adlers[i], len);
  }
  out[pos++] = (uint8_t)(ad >> 24);
  out[pos++] = (uint8_t)(ad >> 16);
  out[pos++] = (uint8_t)(ad >> 8);
  out[pos++] = (uint8_t)(ad);
  return pos;
}

// CRC32 helper so the Python chunk writer can offload big buffers too.
unsigned long fastdeflate_crc32(unsigned long crc, const uint8_t* data, long n) {
  return crc32(crc, data, (uInt)n);
}

// Adaptive PNG scanline filtering (spec heuristic: per row, the filter with
// the minimum sum of absolute SIGNED residuals wins, lowest index on ties —
// identical semantics to utils/export._filter_scanlines_numpy, which remains
// the pure-Python fallback and the byte-for-byte test reference). Rows only read
// RAW bytes of themselves and the row above, so they filter independently in
// parallel. `raw` is h*stride bytes; `out` is h*(1+stride) bytes (filter
// byte + filtered row each). Returns 0 on success, -1 on bad args.
int fastdeflate_png_filter(const uint8_t* raw, long h, long stride, int bpp,
                           int threads, uint8_t* out) {
  if (h < 0 || stride <= 0 || bpp < 1 || bpp > (int)stride) return -1;
  if (threads < 1) threads = 1;
  if (threads > 64) threads = 64;
  if ((long)threads > h && h > 0) threads = (int)h;

  auto run = [&](long y0, long y1) {
    std::vector<uint8_t> cand(5 * stride);
    for (long y = y0; y < y1; ++y) {
      const uint8_t* row = raw + y * stride;
      const uint8_t* up_row = y ? raw + (y - 1) * stride : nullptr;
      long cost[5] = {0, 0, 0, 0, 0};
      for (long j = 0; j < stride; ++j) {
        int cur = row[j];
        int left = j >= bpp ? row[j - bpp] : 0;
        int up = up_row ? up_row[j] : 0;
        int upleft = (up_row && j >= bpp) ? up_row[j - bpp] : 0;
        int p = left + up - upleft;
        int pa = p - left; if (pa < 0) pa = -pa;
        int pb = p - up; if (pb < 0) pb = -pb;
        int pc = p - upleft; if (pc < 0) pc = -pc;
        int pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : upleft);
        uint8_t r[5];
        r[0] = (uint8_t)cur;
        r[1] = (uint8_t)(cur - left);
        r[2] = (uint8_t)(cur - up);
        r[3] = (uint8_t)(cur - ((left + up) >> 1));
        r[4] = (uint8_t)(cur - pred);
        for (int f = 0; f < 5; ++f) {
          int c = r[f];
          cost[f] += c < 256 - c ? c : 256 - c;
          cand[f * stride + j] = r[f];
        }
      }
      int pick = 0;
      for (int f = 1; f < 5; ++f)
        if (cost[f] < cost[pick]) pick = f;  // strict <: first wins ties
      uint8_t* o = out + y * (1 + stride);
      o[0] = (uint8_t)pick;
      std::memcpy(o + 1, cand.data() + (long)pick * stride, stride);
    }
  };

  if (threads == 1 || h < 2) {
    run(0, h);
    return 0;
  }
  std::vector<std::thread> pool;
  long per = (h + threads - 1) / threads;
  for (int i = 0; i < threads; ++i) {
    long y0 = (long)i * per;
    long y1 = y0 + per < h ? y0 + per : h;
    if (y0 >= y1) break;
    pool.emplace_back(run, y0, y1);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
