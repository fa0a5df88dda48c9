// The tile bin: device code shared by the EXACT_KERNEL and EXACT16_KERNEL
// bins (bin_exact.cu, bin_exact16.cu).
//
// Both bins keep, per pixel, a hit count and a winner key whose min decides
// the chunk's candidate. One L2 atomic a point on each bounds a bin at the
// L2's rate of single-element reductions (bin_packed.cu), so here no point
// of the stream touches the planes or issues a global atomic: a chunk's hits
// are aggregated in shared memory, one tile of the canvas a block.
//
// The canvas is cut into runs of 32 pixels, dealt round-robin over T tiles
// (pixel p: run r = p / 32, tile r % T, slot (r / T) * 32 + p % 32), so a
// crowded region of the image spreads over all tiles and a warp of the
// merge still touches 128 contiguous bytes of a plane. T is the least count
// whose tiles fit the SM's shared memory, rounded up to a multiple of the
// SM count (one merge block an SM: 132 tiles of 491 runs at 1920x1080), at
// most MAX_TILES; a larger canvas is binned in bands of MAX_TILES *
// TILE_RUNS runs (18.9M pixels), one round of the five kernels a band.
//
// Per band, five kernels on the caller's stream. The stream is cut into
// contiguous spans of whole 4096-point segments (two an SM for a long
// chunk; a wide mode's span holds at most 2^SPAN_BITS points, see kernel
// 4), one block each in kernels 1 and 4:
//   1. tile_hist_kernel: a shared-memory histogram of a span by tile, stored
//      as the span's column of a T x spans table;
//   2. tile_column_kernel: a warp a tile turns its row of the table into
//      the exclusive prefix over the spans and stores the tile's total;
//   3. tile_scan_kernel: the exclusive scan of the totals, the buckets'
//      first records. A span's range of every bucket is now fixed, so the
//      partition issues no global atomic at all (a cursor a bucket, from
//      which every block reserved its range, serialized a thousand atomics
//      on each address and cost most of the scatter's time);
//   4. tile_scatter_kernel: a counting sort of one segment of the span after
//      another by tile in shared memory, so that a tile's records leave the
//      block as one contiguous run. A record is 8 bytes, one vector store
//      and one vector load: the pixel's slot in its tile, above it in the
//      wide modes the point's offset in its span, and the mode's 32-bit key
//      word. Both passes are bound by the bytes they move (~2.1 TB/s), so
//      the wide modes' stream index does not travel whole: a span's records
//      are neighbours in a bucket, and the merge finds a record's span from
//      its place in the bucket (a 16-byte record with the index took a
//      fifth longer; three 4-byte arrays, and an 8-byte beside a 4-byte
//      array, longer still, for their store transactions). The offset has
//      the 17 bits the slot leaves of a word, so a chunk of more than
//      MAX_SPANS << SPAN_BITS points (134M) is cut into more spans, not
//      longer ones: its table is wider (table_spans), and past 2816 spans
//      (369M points) the merge's tiles shrink by the room the spans' starts
//      take in shared memory (most_tile_runs). Order inside a bucket is
//      free: min commutes. Out-of-bounds points
//      are dropped here, and the pixel-0 flood (escaped orbits bin at pixel
//      (0, 0): 38% of a solar-sail chunk) leaves the stream here: a warp
//      counts its pixel-0 points with a ballot and reduces their key, the
//      block combines its warps in shared memory and issues one atomic pair
//      into the control words. Pixel (0, 0)'s real points take the same way
//      and win by the same key;
//   5. tile_merge_kernel: a block clears its tile in shared memory (the
//      first tile starts from the pixel-0 aggregate, and zeroes it for the
//      next launch), streams its bucket with shared-memory atomics (add the
//      count, min the key, a plain read first sparing the min of a loser;
//      a wide mode's index is the record's span, searched in the tile's row
//      of the table by the record's place, times the span plus the offset),
//      then merges the touched slots into the planes with plain loads and
//      stores, since no other block owns these pixels: count += hits, the
//      strict test against zbuf, zbuf and steps written for winners only.
// Every kernel issues its loads in batches before their first use: with
// one load in flight a thread the scatter and the merge were bound by
// memory latency, not by bytes.
//
// A mode (struct ExactMode, Exact16Mode<...>) gives the key: Key (u64 or
// u32), WIDE (records carry the index), READS_VAL (the key word needs the
// value), key_word(z bits, val bits) with DEAD for a point that counts but
// never wins, key(word, index), empty(), depth(key) and value_bits(key, val).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

namespace bin_tile {

typedef unsigned long long u64;

#define FULL_MASK 0xFFFFFFFFu

// The geometry. tests/test_torch_tile_emulation.py builds these sources for
// the CPU with a shrunk one, to reach many tiles, bands and spans, and the
// shrinking tiles of a very long chunk, on a small canvas and a short stream.
#ifndef SAT_TILE_RUNS
#define SAT_TILE_RUNS 576  // 18,432 pixels: 221,184 B of shared memory at 12 B a pixel
#endif
#ifndef SAT_MAX_TILES
#define SAT_MAX_TILES 1024
#endif
#ifndef SAT_MAX_SPANS
#define SAT_MAX_SPANS 1024
#endif
#ifndef SAT_SPAN_BITS
#define SAT_SPAN_BITS 17  // a point's offset in its span shares a record's word with the slot
#endif
#ifndef SAT_SMEM_BYTES
#define SAT_SMEM_BYTES 232448  // the 227 KB of shared memory a block may ask an SM for
#endif

constexpr int RUN = 32;
constexpr int TILE_RUNS = SAT_TILE_RUNS;
constexpr int MAX_TILES = SAT_MAX_TILES;
constexpr int SLOT_BITS = 15;
constexpr unsigned SLOT_MASK = (1u << SLOT_BITS) - 1u;
constexpr unsigned NO_TILE = 0xFFFFFFFFu;
constexpr unsigned DEAD = 0xFFFFFFFFu;
constexpr int HIST_THREADS = 1024;
constexpr int SCATTER_THREADS = 512, SCATTER_BLOCKS = 2;  // scatter blocks an SM
constexpr int PER_THREAD = 8, SEG = SCATTER_THREADS * PER_THREAD;
constexpr int MERGE_THREADS = 1024, MERGE_BLOCKS = 1;  // merge blocks an SM
constexpr int LOADS = 8;  // independent loads a thread keeps in flight
constexpr int MERGE_LOADS = 4;  // pixels whose plane loads a merging thread keeps in flight

static_assert(TILE_RUNS * RUN <= (1 << SLOT_BITS), "a slot must fit SLOT_BITS");
constexpr int SCAN_TILES = (MAX_TILES + SCATTER_THREADS - 1) / SCATTER_THREADS;  // a thread
static_assert(MAX_TILES <= 1024, "the scan kernel takes one tile a thread");
static_assert(SEG <= (1 << SAT_SPAN_BITS) && (1 << SAT_SPAN_BITS) % SEG == 0,
              "a span is whole segments");

constexpr int MAX_SPANS = SAT_MAX_SPANS;
constexpr int SPAN_BITS = SAT_SPAN_BITS;
static_assert(SLOT_BITS + SPAN_BITS <= 32, "slot and offset share a word");
constexpr int SMEM_BYTES = SAT_SMEM_BYTES;

// Columns of the table of a chunk of m points (ops/kernel_binning.py
// table_words): MAX_SPANS, which holds every chunk of up to MAX_SPANS <<
// SPAN_BITS points, or one a span of 2^SPAN_BITS points.
static inline long long table_spans(long long m) {
  const long long wide = (m + (1LL << SPAN_BITS) - 1) >> SPAN_BITS;
  return wide > MAX_SPANS ? wide : MAX_SPANS;
}

// The control words (ops/kernel_binning.py CONTROL_WORDS), the pixel-0
// aggregate: all zero between launches.
struct Control {
  u64 key0_inv;  // ~(least key of the pixel-0 points), 0 = none
  unsigned n0;   // pixel-0 points
  unsigned pad;
};

struct Band {
  int first_run;   // the band's first run of the canvas
  int runs;        // its runs
  int tiles;       // T
  int tile_runs;   // runs a tile: ceil(runs / T)
  int npix;
  int spans;       // blocks of the histogram and the scatter
  long long span;  // points a span, a multiple of SEG
};

struct Tables {
  unsigned* counts;  // [T][spans]: a span's points a tile, then their prefix over the spans
  unsigned* total;   // [T]: records a tile
  unsigned* base;    // [T]: a bucket's first record
};

// tile << SLOT_BITS | slot of pixel f, NO_TILE when f is outside the canvas
// (flat == npix: out of bounds) or the band
__device__ __forceinline__ unsigned place(int f, const Band& b) {
  if ((unsigned)f >= (unsigned)b.npix) return NO_TILE;
  unsigned r = ((unsigned)f >> 5) - (unsigned)b.first_run;
  if (r >= (unsigned)b.runs) return NO_TILE;
  unsigned k = r / (unsigned)b.tiles, t = r - k * (unsigned)b.tiles;
  return (t << SLOT_BITS) | (k * RUN + ((unsigned)f & 31u));
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive prefix of v over the block's threads; every thread calls it.
// warp_sums: 32 shared words, free again after the call's last barrier.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = warp_inclusive_scan(v);
  __syncthreads();  // the last call's readers are done with warp_sums
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < (int)((blockDim.x + 31) >> 5) ? warp_sums[lane] : 0u;
    unsigned si = warp_inclusive_scan(s);
    warp_sums[lane] = si - s;
  }
  __syncthreads();
  return incl - v + warp_sums[warp];
}

// min over the warp of a 64-bit key; every lane calls it
__device__ __forceinline__ u64 warp_min_u64(u64 k) {
  unsigned hi = (unsigned)(k >> 32);
  unsigned mhi = __reduce_min_sync(FULL_MASK, hi);
  unsigned mlo = __reduce_min_sync(FULL_MASK, hi == mhi ? (unsigned)k : 0xFFFFFFFFu);
  return ((u64)mhi << 32) | mlo;
}

static __global__ void __launch_bounds__(HIST_THREADS)
    tile_hist_kernel(unsigned* __restrict__ counts, const int* __restrict__ flat, long long m,
                     Band band) {
  __shared__ unsigned h[MAX_TILES];
  for (int t = threadIdx.x; t < band.tiles; t += HIST_THREADS) h[t] = 0u;
  __syncthreads();
  const long long lo = blockIdx.x * band.span;
  const long long hi = lo + band.span < m ? lo + band.span : m;
  // LOADS independent loads in flight a thread
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += HIST_THREADS * LOADS) {
    int f[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long i = i0 + u * HIST_THREADS;
      f[u] = i < hi ? flat[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (f[u] == 0 && band.first_run == 0) continue;  // pixel 0 leaves the stream in the scatter
      const unsigned w = place(f[u], band);
      if (w != NO_TILE) atomicAdd(&h[w >> SLOT_BITS], 1u);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < band.tiles; t += HIST_THREADS)
    counts[t * band.spans + blockIdx.x] = h[t];
}

constexpr int COLUMN_WARPS = 8;

static __global__ void __launch_bounds__(COLUMN_WARPS * 32)
    tile_column_kernel(Tables tab, int spans, int tiles) {
  const int lane = threadIdx.x & 31, t = blockIdx.x * COLUMN_WARPS + (threadIdx.x >> 5);
  if (t >= tiles) return;  // whole warps leave; no block barrier below
  unsigned before = 0u;
  for (int b0 = 0; b0 < spans; b0 += 32) {
    const int b = b0 + lane;
    const unsigned v = b < spans ? tab.counts[t * spans + b] : 0u;
    const unsigned incl = warp_inclusive_scan(v);
    if (b < spans) tab.counts[t * spans + b] = before + incl - v;
    before += __shfl_sync(FULL_MASK, incl, 31);
  }
  if (lane == 0) tab.total[t] = before;
}

static __global__ void __launch_bounds__(1024) tile_scan_kernel(Tables tab, int tiles) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x;
  unsigned before = block_exclusive_scan(t < tiles ? tab.total[t] : 0u, warp_sums);
  if (t < tiles) tab.base[t] = before;
}

template <class Mode>
static __global__ void __launch_bounds__(SCATTER_THREADS, SCATTER_BLOCKS)
    tile_scatter_kernel(Control* __restrict__ ctl, unsigned* __restrict__ rec, Tables tab,
                        const int* __restrict__ flat, const unsigned* __restrict__ z,
                        const unsigned* __restrict__ val, long long m, Band band) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* h = reinterpret_cast<unsigned*>(smem);  // points a tile, then first staged record
  unsigned* shift = h + MAX_TILES;                  // bucket position - staged position
  unsigned* next = shift + MAX_TILES;               // the span's next record in each bucket
  uint2* staged = reinterpret_cast<uint2*>(next + MAX_TILES);  // (tile | slot, key word)
  unsigned* staged_offset = reinterpret_cast<unsigned*>(staged + SEG);  // wide modes
  __shared__ unsigned warp_sums[32];
  __shared__ unsigned total, block_n0;
  __shared__ u64 block_key0;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool has0 = band.first_run == 0;
  for (int t = tid; t < band.tiles; t += SCATTER_THREADS)
    next[t] = tab.base[t] + tab.counts[t * band.spans + blockIdx.x];
  if (tid == 0) {
    block_n0 = 0u;
    block_key0 = ~0ull;
  }
  unsigned n0 = 0u;  // this warp's pixel-0 points and their least key (warp-uniform)
  u64 key0 = ~0ull;
  uint2* records = reinterpret_cast<uint2*>(rec);
  const long long lo = blockIdx.x * band.span;
  const long long hi = lo + band.span < m ? lo + band.span : m;
  // one segment after another; every thread runs every iteration, so the
  // pixel-0 votes see whole warps also on the stream's ragged tail
  for (long long first = lo; first < hi; first += SEG) {
    for (int t = tid; t < band.tiles; t += SCATTER_THREADS) h[t] = 0u;
    __syncthreads();
    unsigned w0[PER_THREAD], w1[PER_THREAD], rank[PER_THREAD];
    {
      // every load of the segment in flight before the first use
      int f[PER_THREAD];
      unsigned vb[PER_THREAD];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const long long i = first + k * SCATTER_THREADS + tid;
        f[k] = i < hi ? __ldcs(flat + i) : -1;
        w1[k] = i < hi ? __ldcs(z + i) : 0u;
        vb[k] = (Mode::READS_VAL && i < hi) ? __ldcs(val + i) : 0u;
      }
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const bool zero = has0 && f[k] == 0;
        w0[k] = zero ? NO_TILE : place(f[k], band);
        w1[k] = (zero || w0[k] != NO_TILE) ? Mode::key_word(w1[k], vb[k]) : DEAD;
        const unsigned hits = __ballot_sync(FULL_MASK, zero);
        if (hits) {  // warp-uniform
          n0 += __popc(hits);
          const unsigned index = (unsigned)(first + k * SCATTER_THREADS + tid);
          const u64 mine = (zero && w1[k] != DEAD) ? (u64)Mode::key(w1[k], index) : ~0ull;
          const u64 least = warp_min_u64(mine);
          key0 = least < key0 ? least : key0;
        }
        rank[k] = w0[k] != NO_TILE ? atomicAdd(&h[w0[k] >> SLOT_BITS], 1u) : 0u;
      }
    }
    __syncthreads();

    // h becomes each tile's first staged record
    {
      const int t0 = tid * SCAN_TILES;  // this thread's tiles
      unsigned points[SCAN_TILES], mine = 0u;
#pragma unroll
      for (int u = 0; u < SCAN_TILES; ++u) {
        points[u] = t0 + u < band.tiles ? h[t0 + u] : 0u;
        mine += points[u];
      }
      unsigned before = block_exclusive_scan(mine, warp_sums);
      if (tid == SCATTER_THREADS - 1) total = before + mine;
#pragma unroll
      for (int u = 0; u < SCAN_TILES; ++u) {
        const int t = t0 + u;
        if (t < band.tiles) h[t] = before;
        if (points[u]) {
          shift[t] = next[t] - before;
          next[t] += points[u];
        }
        before += points[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (w0[k] == NO_TILE) continue;
      const unsigned pos = h[w0[k] >> SLOT_BITS] + rank[k];
      staged[pos] = make_uint2(w0[k], w1[k]);
      if (Mode::WIDE) staged_offset[pos] = (unsigned)(first - lo) + k * SCATTER_THREADS + tid;
    }
    __syncthreads();
    // a tile's records are neighbours in the staging area and in the bucket
    for (unsigned j = tid; j < total; j += SCATTER_THREADS) {
      const uint2 r = staged[j];
      const unsigned to = j + shift[r.x >> SLOT_BITS];
      const unsigned offset = Mode::WIDE ? staged_offset[j] << SLOT_BITS : 0u;
      records[to] = make_uint2((r.x & SLOT_MASK) | offset, r.y);
    }
    __syncthreads();  // the staging area is free for the next segment
  }

  // the pixel-0 aggregate: the warps' totals in shared memory, then one
  // atomic pair a block
  if (lane == 0 && n0) {
    atomicAdd(&block_n0, n0);
    atomicMin(&block_key0, key0);
  }
  __syncthreads();
  if (tid == 0 && block_n0) {
    atomicAdd(&ctl->n0, block_n0);
    if (block_key0 != ~0ull) atomicMax(&ctl->key0_inv, ~block_key0);
  }
}

template <class Mode>
static __global__ void __launch_bounds__(MERGE_THREADS, MERGE_BLOCKS)
    tile_merge_kernel(unsigned* __restrict__ count, unsigned* __restrict__ steps,
                      float* __restrict__ zbuf, Control* __restrict__ ctl,
                      const unsigned* __restrict__ rec, Tables tab,
                      const unsigned* __restrict__ val, Band band) {
  typedef typename Mode::Key Key;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = band.tile_runs * RUN;
  Key* key = reinterpret_cast<Key*>(smem);
  unsigned* hits = reinterpret_cast<unsigned*>(key + slots);
  unsigned* starts = hits + slots;  // wide modes: each span's first record in the bucket
  const int tid = threadIdx.x;
  const uint2* records = reinterpret_cast<const uint2*>(rec);
  for (int tile = blockIdx.x; tile < band.tiles; tile += gridDim.x) {
    const unsigned n = tab.total[tile], base = tab.base[tile];
    const bool first = tile == 0 && band.first_run == 0;  // the tile of pixel (0, 0)
    if (n != 0u || first) {  // block-uniform
      for (int s = tid; s < slots; s += MERGE_THREADS) {
        key[s] = Mode::empty();
        hits[s] = 0u;
      }
      if (Mode::WIDE)
        for (int b = tid; b < band.spans; b += MERGE_THREADS)
          starts[b] = tab.counts[tile * band.spans + b];
      if (first && tid == 0) {  // slot 0 is this thread's own
        hits[0] = ctl->n0;
        key[0] = (Key)~ctl->key0_inv;
        ctl->n0 = 0u;
        ctl->key0_inv = 0ull;
      }
      __syncthreads();
      // a warp takes 32 * LOADS neighbouring records at a time, LOADS in
      // flight a thread before the first shared atomic; a wide mode's span
      // is searched once for the warp's first record and walked from there
      for (unsigned c0 = (tid >> 5) * (32 * LOADS); c0 < n; c0 += MERGE_THREADS * LOADS) {
        uint2 r[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const unsigned j = c0 + u * 32 + (tid & 31);
          r[u] = __ldcs(records + base + (j < n ? j : c0));
        }
        int span = 0;  // the last span that starts at or before the record
        if (Mode::WIDE) {
          int above = band.spans;
          while (above - span > 1) {
            const int mid = (span + above) >> 1;
            if (starts[mid] <= c0)
              span = mid;
            else
              above = mid;
          }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const unsigned j = c0 + u * 32 + (tid & 31);
          if (j >= n) break;
          const unsigned slot = r[u].x & SLOT_MASK;
          atomicAdd(&hits[slot], 1u);
          if (r[u].y == DEAD) continue;
          unsigned index = 0u;
          if (Mode::WIDE) {
            while (span + 1 < band.spans && starts[span + 1] <= j) ++span;
            index = (unsigned)(span * band.span) + (r[u].x >> SLOT_BITS);
          }
          const Key k = Mode::key(r[u].y, index);
          if (k < *(volatile Key*)&key[slot]) atomicMin(&key[slot], k);
        }
      }
      __syncthreads();
      // the touched slots into the planes, MERGE_LOADS pixels' loads in
      // flight a thread
      for (int s0 = tid; s0 < slots; s0 += MERGE_LOADS * MERGE_THREADS) {
        unsigned c[MERGE_LOADS], standing[MERGE_LOADS];
        float zb[MERGE_LOADS];
        Key k[MERGE_LOADS];
        int p[MERGE_LOADS];
#pragma unroll
        for (int u = 0; u < MERGE_LOADS; ++u) {
          const int s = s0 + u * MERGE_THREADS;
          c[u] = s < slots ? hits[s] : 0u;
          if (!c[u]) continue;
          k[u] = key[s];
          p[u] = ((band.first_run + (s >> 5) * band.tiles + tile) << 5) | (s & 31);
          standing[u] = count[p[u]];
          if (k[u] != Mode::empty()) zb[u] = zbuf[p[u]];
        }
#pragma unroll
        for (int u = 0; u < MERGE_LOADS; ++u) {
          if (!c[u]) continue;
          count[p[u]] = standing[u] + c[u];
          if (k[u] == Mode::empty()) continue;
          const float z_new = Mode::depth(k[u]);
          if (z_new > zb[u]) {  // strict: a tie keeps the standing value
            zbuf[p[u]] = z_new;
            steps[p[u]] = Mode::value_bits(k[u], val);
          }
        }
      }
    }
    __syncthreads();  // the tile's shared memory is free for the next one
  }
}

static inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The most runs a tile may hold: TILE_RUNS, or fewer where the shared memory
// left beside the starts of a wide mode's spans holds no more.
static inline int most_tile_runs(int slot_bytes, int starts_words) {
  const int fit = (SMEM_BYTES - 4 * starts_words) / (RUN * slot_bytes);
  return fit < TILE_RUNS ? fit : TILE_RUNS;
}

// T of a band of `runs` runs: the least count whose tiles hold at most
// `most_runs` runs, evened over the merge blocks the card holds at once.
static inline int band_tiles(int runs, int most_runs) {
  const int wave = MERGE_BLOCKS * sm_count();
  long long tiles = (long long)ceil_div(ceil_div(runs, most_runs), wave) * wave;
  if (tiles > MAX_TILES) tiles = MAX_TILES;
  return (int)(tiles > runs ? runs : tiles);
}

// One chunk into the EXACT planes. ctl_words: the control words; rec: a
// record (2 words) a point, then the tables: table_spans(m) * MAX_TILES
// counts, MAX_TILES totals, MAX_TILES bucket starts.
//
// A chunk is always binned in one go, however long: only that keeps its
// result (a NaN depth that takes its pixel blocks every other point of the
// chunk there, not of a part of it).
template <class Mode>
static int tile_bin(unsigned* count, float* steps, float* zbuf, void* ctl_words, unsigned* rec,
                    const int* flat, const unsigned* z, const unsigned* val, long long m, int npix,
                    cudaStream_t s) {
  if (m <= 0 || npix <= 0) return (int)cudaSuccess;  // nothing can land on the canvas
  Control* ctl = static_cast<Control*>(ctl_words);
  const int scatter_smem = (3 * MAX_TILES + (Mode::WIDE ? 3 : 2) * SEG) * (int)sizeof(unsigned);
  const int slot_bytes = (int)sizeof(typename Mode::Key) + (int)sizeof(unsigned);
  static bool configured[64];  // by device: the attribute belongs to the device's context
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    cudaFuncSetAttribute(tile_scatter_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         scatter_smem);
    cudaFuncSetAttribute(tile_merge_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  const int sms = sm_count();
  Tables tab;
  tab.counts = rec + 2 * m;
  tab.total = tab.counts + table_spans(m) * MAX_TILES;
  tab.base = tab.total + MAX_TILES;
  // spans: whole segments, one wave of scatter blocks when the chunk is long;
  // a wide mode's no longer than the offsets a record holds
  const long long segments = (m + SEG - 1) / SEG;
  const int most = SCATTER_BLOCKS * sms < MAX_SPANS ? SCATTER_BLOCKS * sms : MAX_SPANS;
  long long span = (segments + most - 1) / most * SEG;
  if (Mode::WIDE && span > (1LL << SPAN_BITS)) span = 1LL << SPAN_BITS;
  const int spans = ceil_div(m, span);
  const int starts_words = Mode::WIDE ? spans : 0;
  const int most_runs = most_tile_runs(slot_bytes, starts_words);
  if (most_runs < 1) return (int)cudaErrorInvalidValue;
  const long long nruns = ((long long)npix + RUN - 1) / RUN;
  const long long band_runs = (long long)MAX_TILES * most_runs;
  for (long long r0 = 0; r0 < nruns; r0 += band_runs) {
    Band b;
    b.first_run = (int)r0;
    b.runs = (int)(nruns - r0 < band_runs ? nruns - r0 : band_runs);
    b.tiles = band_tiles(b.runs, most_runs);
    b.tile_runs = ceil_div(b.runs, b.tiles);
    b.npix = npix;
    b.span = span;
    b.spans = spans;
    tile_hist_kernel<<<b.spans, HIST_THREADS, 0, s>>>(tab.counts, flat, m, b);
    tile_column_kernel<<<ceil_div(b.tiles, COLUMN_WARPS), COLUMN_WARPS * 32, 0, s>>>(
        tab, b.spans, b.tiles);
    tile_scan_kernel<<<1, 1024, 0, s>>>(tab, b.tiles);
    tile_scatter_kernel<Mode><<<b.spans, SCATTER_THREADS, scatter_smem, s>>>(
        ctl, rec, tab, flat, z, val, m, b);
    const int wave = MERGE_BLOCKS * sms;
    const int merge_blocks = b.tiles < wave ? b.tiles : wave;
    const int merge_smem = b.tile_runs * RUN * slot_bytes + 4 * starts_words;
    tile_merge_kernel<Mode><<<merge_blocks, MERGE_THREADS, merge_smem, s>>>(
        count, reinterpret_cast<unsigned*>(steps), zbuf, ctl, rec, tab, val, b);
  }
  return (int)cudaGetLastError();
}

}  // namespace bin_tile
