// CPU emulation of the CUDA subset the tile bin (csrc/bin_tile.cuh), the
// depth bin (csrc/bin_depth.cu), kernel A (csrc/map_emit.cuh), kernel T
// (csrc/tonemap.cu) and kernel F (csrc/png_filter.cu) use, for the
// tests/test_torch_*_emulation.py files. A block's CUDA threads are fibers
// of one OS thread, run round-robin: a fiber runs until it waits at a barrier
// (the block's, or its warp's inside a vote, shuffle or reduction) and the
// next one takes over, so a run is deterministic and an atomic is a plain
// update.
// Blocks run one after another, which makes a __shared__ variable a static.
#pragma once
#include <setjmp.h>
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline Idx threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
#ifndef EMU_SMS
#define EMU_SMS 3
#endif
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = EMU_SMS; return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
#ifndef EMU_RESIDENT
#define EMU_RESIDENT 2
#endif
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = EMU_RESIDENT;
  return 0;
}
inline int cudaGetLastError() { return 0; }
namespace emu {
constexpr size_t STACK = 64 << 10;
// A barrier of fibers: the last to arrive opens it for the others.
struct Barrier {
  unsigned parties = 0, waiting = 0, generation = 0;
  void open_if_full() { if (waiting && waiting == parties) { waiting = 0; ++generation; } }
};
struct Warp { Barrier bar; unsigned long long slot[2][32]; };
// A named barrier (bar.sync / bar.arrive with a thread count): it opens when
// that many threads have arrived, waiting or not.
struct Named { unsigned arrived = 0, generation = 0; };
struct Fiber { ucontext_t context; jmp_buf resume; bool started = false, done = false; };
inline unsigned char* dyn_smem;
inline Barrier block_bar;
inline Named named[16];
inline Warp* warps;
inline Fiber* fibers;
inline jmp_buf scheduler;
inline std::function<void()> kernel;
// A started fiber is left and taken up again by _setjmp and _longjmp, which
// unlike swapcontext make no system call.
inline void yield() { if (!_setjmp(fibers[threadIdx.x].resume)) _longjmp(scheduler, 1); }
inline void wait(Barrier& b) {
  const unsigned g = b.generation;
  ++b.waiting;
  b.open_if_full();
  while (b.generation == g) yield();
}
inline void leave(Barrier& b) { --b.parties; b.open_if_full(); }
inline void named_arrive(int id, unsigned n) {
  if (++named[id].arrived == n) { named[id].arrived = 0; ++named[id].generation; }
}
inline void named_sync(int id, unsigned n) {
  const unsigned g = named[id].generation;
  named_arrive(id, n);
  while (named[id].generation == g) yield();
}
inline void run_fiber() {
  kernel();
  fibers[threadIdx.x].done = true;
  leave(block_bar);  // as on the card, a thread that has returned holds no barrier up
  leave(warps[threadIdx.x >> 5].bar);
  yield();
}
template <class F> void launch(unsigned grid, unsigned block, size_t smem, F f) {
  if (block % 32) { std::fprintf(stderr, "block of %u threads\n", block); std::abort(); }
  gridDim.x = grid; blockDim.x = block;
  kernel = f;
  // the fibers' stacks, kept from launch to launch and never cleared: a
  // fiber touches a page or two of its own
  static std::unique_ptr<char[]> stacks;
  static unsigned stacks_for = 0;
  if (block > stacks_for) {
    stacks.reset(new char[(size_t)block * STACK]);
    stacks_for = block;
  }
  std::unique_ptr<Fiber[]> fs(new Fiber[block]);
  std::unique_ptr<Warp[]> ws(new Warp[block / 32]);
  fibers = fs.get(); warps = ws.get();
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::vector<unsigned char> mem(smem + 16, 0xAB);
    dyn_smem = mem.data() + ((16 - ((uintptr_t)mem.data() & 15)) & 15);
    block_bar = Barrier{block};
    for (Named& n : named) n = Named{};
    for (unsigned w = 0; w < block / 32; ++w) warps[w].bar = Barrier{32};
    for (unsigned t = 0; t < block; ++t) {
      fibers[t].started = fibers[t].done = false;
      getcontext(&fibers[t].context);
      fibers[t].context.uc_stack.ss_sp = stacks.get() + (size_t)t * STACK;
      fibers[t].context.uc_stack.ss_size = STACK;
      fibers[t].context.uc_link = nullptr;
      makecontext(&fibers[t].context, run_fiber, 0);
    }
    for (volatile unsigned live = block; live;) {
      live = 0;
      for (volatile unsigned t = 0; t < block; t = t + 1) {
        if (fibers[t].done) continue;
        threadIdx.x = t;
        if (!_setjmp(scheduler)) {
          if (fibers[t].started) _longjmp(fibers[t].resume, 1);
          fibers[t].started = true;
          setcontext(&fibers[t].context);
        }
        live = live + !fibers[t].done;
      }
    }
  }
}
// Every lane of the warp gives a value and gets combine(all 32). The slots
// alternate between two sets, so one barrier a call is enough: no lane can
// be two calls ahead of another.
template <class T, class C> T collect(T v, C combine) {
  Warp& w = warps[threadIdx.x >> 5];
  unsigned long long* slot = w.slot[w.bar.generation & 1];
  slot[threadIdx.x & 31] = (unsigned long long)v;
  wait(w.bar);
  return combine(slot);
}
}  // namespace emu
inline void __syncthreads() { emu::wait(emu::block_bar); }
inline unsigned __ballot_sync(unsigned, bool p) {
  return emu::collect<unsigned>(p, [](unsigned long long* s) {
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r |= (unsigned)(s[l] != 0) << l;
    return r;
  });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu::collect<unsigned>(v, [](unsigned long long* s) {
    unsigned r = ~0u;
    for (int l = 0; l < 32; ++l) r = (unsigned)s[l] < r ? (unsigned)s[l] : r;
    return r;
  });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return emu::collect<unsigned>(v, [](unsigned long long* s) {
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r = (unsigned)s[l] > r ? (unsigned)s[l] : r;
    return r;
  });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return emu::collect<unsigned>(v, [](unsigned long long* s) {
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r += (unsigned)s[l];
    return r;
  });
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, int d) {
  int lane = threadIdx.x & 31;
  return emu::collect<unsigned>(
      v, [=](unsigned long long* s) { return (unsigned)s[lane >= d ? lane - d : lane]; });
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return emu::collect<unsigned>(v, [=](unsigned long long* s) { return (unsigned)s[src & 31]; });
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
using std::min;
template <class T> T atomicAdd(T* p, T v) { T old = *p; *p = old + v; return old; }
template <class T> T atomicMin(T* p, T v) { T old = *p; if (v < old) *p = v; return old; }
template <class T> T atomicMax(T* p, T v) { T old = *p; if (v > old) *p = v; return old; }
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> T __ldca(const T* p) { return *p; }
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
