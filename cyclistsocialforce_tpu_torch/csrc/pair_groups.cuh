// Thread-group pieces shared by the block-sparse pair kernels
// (pair_forces.cu, pair_forces_unrolled.cu, pair_forces_db.cu).
//
// All three kernels give a receiver block of kBlock agents (64, 128 or 256,
// a template parameter) to one CTA of several thread groups. A group is
// kBlock / kRecv threads (whole warps: 32, 64 or 128) that together hold
// all kBlock receivers, kRecv = 2 per thread: two independent FP32/MUFU
// chains per thread, fed by one broadcast read of each source row. The
// groups divide the block's source rows between them (each kernel its own
// way) and meet once, at the end, where their partial sums are added in
// group order: no atomics, so the same call gives the same bits every time.
// Here: the CTA's shape for each block, a group's named barrier and its
// vote, the receivers' load, the probe-first distance-screen vote, that
// final sum, and the two ways a tile reaches shared memory (cp.async per
// thread; one bulk copy that reports to an mbarrier).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace csf {

constexpr int kRecv = 2;                        // receivers per thread

// The shape of a CTA for a receiver block of kBlock agents. Block 128 is
// the shape measured on an H100 (PERF.md): 8 groups of 64 threads, 512
// threads, 2 CTAs per SM, so __launch_bounds__ caps a thread at 64
// registers. The other blocks keep that register budget (threads x CTAs
// per SM = 1024): block 64 is 8 groups of one warp (256 threads, 4 CTAs),
// block 256 is 4 groups of 128 threads (512 threads, 2 CTAs; 8 such
// groups would be 1024 threads at ~60 registers, more than an SM holds
// twice).
template <int kBlock>
struct Cta {
  static_assert(kBlock == 64 || kBlock == 128 || kBlock == 256,
                "the receiver blocks the kernels are compiled for");
  static constexpr int kGroupThreads = kBlock / kRecv;   // threads per group
  static constexpr int kGroups = kBlock == 256 ? 4 : 8;
  static constexpr int kThreads = kGroups * kGroupThreads;
  static constexpr int kMinBlocks = 1024 / kThreads;      // CTAs per SM
  static_assert(kGroupThreads % 32 == 0, "a group is whole warps");
  // named barrier 0 is __syncthreads', so a CTA has at most 15 groups
  static_assert(kGroups <= 15, "one named barrier per group");
};

// Named barrier of group g: barrier 0 is __syncthreads'.
__device__ __forceinline__ int group_barrier(int g) { return 1 + g; }

// wait for the kGroupThreads threads of this thread's group (its named
// barrier `id`)
template <int kGroupThreads>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kGroupThreads)
               : "memory");
}

// is `v` true on any of the kGroupThreads threads of this thread's group?
template <int kGroupThreads>
__device__ __forceinline__ bool group_any(bool v, int id) {
  int any;
  asm volatile(
      "{\n"
      "  .reg .pred p, q;\n"
      "  setp.ne.s32 p, %1, 0;\n"
      "  bar.red.or.pred q, %2, %3, p;\n"
      "  selp.s32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(any)
      : "r"(static_cast<int>(v)), "r"(id), "n"(kGroupThreads)
      : "memory");
  return any != 0;
}

// This thread's receivers of block b (receiver lt + i kGroupThreads of the
// block for thread lt of a group), their sums set to 0.
template <int kBlock>
__device__ __forceinline__ void load_receivers(const float* recv, int npad,
                                               int b, int lt,
                                               Receiver (&rc)[kRecv],
                                               float (&fx)[kRecv],
                                               float (&fy)[kRecv]) {
  constexpr int kGroupThreads = Cta<kBlock>::kGroupThreads;
#pragma unroll
  for (int i = 0; i < kRecv; ++i) {
    rc[i] = load_receiver(recv, npad, b * kBlock + lt + i * kGroupThreads);
    fx[i] = 0.0f;
    fy[i] = 0.0f;
  }
}

// Does some pair of source rows [j0, j0 + n) of `tile` and the group's
// kBlock receivers lie within the cutoff? The plain version's test of a
// screened strip: its minimum covers inactive and pad rows. The group votes
// with a barrier reduction, first on one probe pair per receiver (receiver
// rr against row j0 + rr mod n), which settles most strips, then, if no
// probe was in range, on every pair. Every thread of the group must call
// it; all get the same answer.
template <int kBlock>
__device__ __forceinline__ bool group_in_range(const float4* tile, int j0,
                                               int n, int lt,
                                               const Receiver (&rc)[kRecv],
                                               float cutoff2, int bar) {
  constexpr int kGroupThreads = Cta<kBlock>::kGroupThreads;
  const float4 a = tile[(j0 + lt % n) * 4];
  bool near = false;
#pragma unroll
  for (int i = 0; i < kRecv; ++i) {
    near |= rho2_rn(a.x, a.y, rc[i]) <= cutoff2;
  }
  if (group_any<kGroupThreads>(near, bar)) return true;
  float rho2_min = INFINITY;
  for (int j = j0; j < j0 + n; ++j) {
    const float4 q = tile[j * 4];
#pragma unroll
    for (int i = 0; i < kRecv; ++i) {
      rho2_min = fminf(rho2_min, rho2_rn(q.x, q.y, rc[i]));
    }
  }
  return group_any<kGroupThreads>(rho2_min <= cutoff2, bar);
}

// The groups' partial sums `part` ([kGroups][2][kBlock], complete in
// shared memory) added in group order into out [2, npad]. Every thread of
// the CTA calls it.
template <int kBlock>
__device__ __forceinline__ void add_parts(const float* part, float* out,
                                          int npad, int b) {
  using C = Cta<kBlock>;
  for (int o = threadIdx.x; o < 2 * kBlock; o += C::kThreads) {
    const int c = o / kBlock, rr = o % kBlock;     // c: 0 fx, 1 fy
    float sum = part[c * kBlock + rr];
#pragma unroll
    for (int q = 1; q < C::kGroups; ++q) {
      sum += part[(2 * q + c) * kBlock + rr];
    }
    out[c * npad + b * kBlock + rr] = sum;
  }
}

// The end of a kernel: the groups' partial sums meet in `part`
// ([kGroups][2][kBlock] floats of shared memory) and are added in group
// order into out [2, npad]; an inactive receiver gets 0 (the plain
// version's mask drops each of its pairs). Every thread of the CTA calls
// it.
template <int kBlock>
__device__ __forceinline__ void sum_groups(float* part, int g, int lt,
                                           const Receiver (&rc)[kRecv],
                                           const float (&fx)[kRecv],
                                           const float (&fy)[kRecv],
                                           float* out, int npad, int b) {
  using C = Cta<kBlock>;
#pragma unroll
  for (int i = 0; i < kRecv; ++i) {
    const int rr = lt + i * C::kGroupThreads;
    part[(2 * g) * kBlock + rr] = rc[i].act ? fx[i] : 0.0f;
    part[(2 * g + 1) * kBlock + rr] = rc[i].act ? fy[i] : 0.0f;
  }
  __syncthreads();
  add_parts<kBlock>(part, out, npad, b);
}

// ---- cp.async: each thread copies 16 bytes ---------------------------------

// 16-byte global -> shared copy that bypasses L1 (cp.async.cg)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bulk copies: one thread copies a tile, an mbarrier reports it ---------
//
// A source tile is block_src x 64 contiguous bytes, 16-byte aligned, so
// one thread can hand the whole copy to the copy engine
// (cp.async.bulk, no tensor map) and go on; the bytes' arrival completes
// a phase of an mbarrier in shared memory, on whose parity the consumers
// wait. A barrier's phases alternate parity 0, 1, 0, ...

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise a barrier whose phase completes after `arrivals` arrivals
// (and the bytes they announced). One thread per barrier; follow with
// mbar_init_fence and a __syncthreads before any other use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// make initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = shared_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` announcing `bytes`, and start the copy of `bytes` (a
// multiple of 16) from global `gmem` to shared `smem` that delivers them.
// Shared memory that threads have read is handed back to the copy engine
// only after those threads have synchronised with the caller; the proxy
// fence orders what the caller has so observed before the engine's write.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = shared_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(b)
      : "memory");
}

}  // namespace csf
