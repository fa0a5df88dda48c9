// EXACT_KERNEL-strategy bin of one point chunk.
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel_exact
// (strange_attractor_tpu/ops/kernel_binning.py:542-579): the stable section
// sort on (flat, ~mono(z)) (_sections, :415-442), the row apply
// (_run_apply / _make_apply_kernel, :445-470 / :170-332) with _flush_exact
// (:352) and the strict z-test merge. It computes what that pipeline
// computes: every in-bounds point counts; per pixel the chunk's candidate
// is the point of greatest z (zeros canonicalized to +0.0), the earliest
// emitted on equal z; it replaces the standing plane only if strictly
// greater (the reference's z2 > zbuf, src/lib.rs:818-833), and steps takes
// its value's f32 bits.
//
// Design: the tile bin of bin_tile.cuh with the key
// (~mono(z)) << 32 | index, index = the point's position in the step-major
// stream, JAX's emission order. The smallest key is the greatest z, then
// the earliest point: the first of the pixel's run in JAX's stable
// descending-z sort. Min commutes, so the winner is deterministic whatever
// the order of the shared-memory atomics. A record is 8 bytes (slot and the
// point's offset in its span, ~mono(z)); the merge rebuilds the index and
// reads the winner's value through it.
// The sort and the one-hot int8 MXU dot existed to dodge the TPU's
// scalar-scatter floor; on Hopper the partition by tile is a counting sort
// in shared memory and the apply a tile of shared-memory atomics.
//
// What bounds it on the H100: the roofline bound (the stream read once,
// each touched cell of three planes read and written once) is ~19 us a
// 4M-point flagship chunk. The partition reads the stream twice (flat once
// more for the histogram) and writes and reads an 8-byte record a point,
// ~150 MB through the 50 MB L2, and no point issues a global atomic, where
// one L2 reduction and one L2 key read a point held the atomics design at
// 0.132 ms a flagship chunk and the pixel-0 flood at 1.5 ms a solar-sail
// chunk. The tile bin took 0.089 and 0.088 ms in the same call, the two
// packages timed in turns by perf_probe.py before the path of chunks above
// 2^27 points got its present form (NVIDIA H100 80GB HBM3, 700.00 W):
// histogram 12 us, scatter 34, merge 28, both moving their bytes at ~2.1
// TB/s. These sources read 0.087-0.089 and 0.087-0.088 ms in four runs of
// chip_smoke.py (same card and limit). With a 16-byte record (the index whole) an earlier build took
// 0.105 ms: scatter 47, merge 33. The 64-bit key min in shared memory is a
// compare-and-swap loop; a plain read first spares it for the points that
// lose, and it beat two 32-bit rounds over the bucket (33 against 62 us of
// merge, 16-byte records, perf_probe.py on edited copies).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bin_tile.cuh"

struct ExactMode {
  typedef bin_tile::u64 Key;
  static constexpr bool WIDE = true;
  static constexpr bool READS_VAL = false;  // the merge reads the winner's value
  __host__ __device__ static constexpr Key empty() { return ~0ull; }
  // ~mono(canon z): equals DEAD only for the NaN of all ones, which as the
  // pixel's lone candidate fails the strict test anyway
  __device__ static unsigned key_word(unsigned b, unsigned) {
    if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
    return ~((b >> 31) ? ~b : (b | 0x80000000u));
  }
  __device__ static Key key(unsigned word, unsigned index) { return ((Key)word << 32) | index; }
  __device__ static float depth(Key k) {
    unsigned mono = ~(unsigned)(k >> 32);
    return __uint_as_float((mono >> 31) ? (mono & 0x7FFFFFFFu) : ~mono);
  }
  __device__ static unsigned value_bits(Key k, const unsigned* val) { return val[(unsigned)k]; }
};

extern "C" int sat_bin_exact(unsigned* count, float* steps, float* zbuf, void* control,
                             unsigned* records, const int* flat, const unsigned* z,
                             const unsigned* val, long long m, int npix, void* stream) {
  return bin_tile::tile_bin<ExactMode>(count, steps, zbuf, control, records, flat, z, val, m,
                                       npix, (cudaStream_t)stream);
}

// T of the first band of a canvas of npix pixels under a chunk of ordinary
// length: what a check needs to aim a stream at one tile or at tile edges.
extern "C" int sat_bin_tiles(int npix) {
  const long long nruns = ((long long)npix + bin_tile::RUN - 1) / bin_tile::RUN;
  const long long band = (long long)bin_tile::MAX_TILES * bin_tile::TILE_RUNS;
  return bin_tile::band_tiles((int)(nruns < band ? nruns : band), bin_tile::TILE_RUNS);
}
