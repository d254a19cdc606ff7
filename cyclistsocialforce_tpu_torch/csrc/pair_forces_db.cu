// Block-sparse pairwise repulsive-force sum through a ring of source
// tiles, with the tile-level distance screen.
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel_db (one program per receiver block; the neighbor tiles
// stream through a _DB_DEPTH = 4 slot ring refilled by async copies; the
// tile screen at the cutoff always on; per-source field parameters always,
// block_src == block), in each of its forms: single-family twod or
// mixed-family (each row's own field, twod or legacy, by its column 13),
// FOV cone on or off, priority to the right on or off. The per-pair math
// is csf::add_pairs (pair_math.cuh), the thread groups' shared pieces are
// in pair_groups.cuh; both are shared with pair_forces.cu.
//
// What bounds it. The pair math, as in pair_forces.cu: 5 MUFU operations
// and ~66 instructions per twod pair, so instruction issue bounds it
// (0.20 ms on an H100 for the 1.04e8 pairs of the 100k-agent crowd at
// block_src = 128, above the MUFU floor of 0.125 ms); the bytes (an 8 KB
// tile per slot, from L2) are small. What is particular to this kernel is
// the ring: every tile is shared by the whole CTA, so a slot's refill and
// the tile's screen vote are CTA-wide events, and a CTA-wide barrier
// around each of them would stall all 16 warps three times per tile.
//
// Design, against each of those costs:
// - Every group works on every tile. A receiver block of kBlock agents
//   (64, 128 or 256) is one CTA of kGroups groups of kBlock / 2 threads, 2
//   receivers per thread (csf::Cta, pair_groups.cuh); group g takes rows
//   [g s, g s + s) of each tile (s = kBlock / kGroups: 8, 16 or 64) for
//   all kBlock receivers, so the groups' shares are equal whatever the
//   row's count. At block 128, 2 CTAs (32 warps) fit an SM beside the
//   2 x 32 KB of rings; the ring is dynamic shared memory, sized by the
//   block (Ring<kBlock>).
// - A ring without CTA-wide barriers. Each slot has a "full" mbarrier,
//   which the tile's bulk copy (cp.async.bulk, issued by one thread)
//   completes and on whose parity the consumers wait, and a count of the
//   warps that are done with the slot. The warp that brings the count to
//   the CTA's warps (16 at block 128) -- the last reader, whichever it is -- resets it and issues the
//   copy of tile k + 4 into the slot at once; nobody waits for the slot to
//   empty, and up to 3 further tiles are already resident or in flight.
// - The screen vote. A tile is admitted iff some pair of its rows and the
//   block's receivers lies within the cutoff (the plain version's
//   test; its minimum covers inactive and pad rows). Each group votes on
//   its own strip with one barrier reduction over its threads
//   (csf::group_in_range: a probe pair per receiver, the full minimum only
//   if no probe is in range). A group that finds a pair in range knows the
//   tile is admitted: it says so in the slot's flag, arrives on the slot's
//   "voted" mbarrier and starts on its rows at once. Only a group that
//   finds none waits for the other groups' arrivals and reads the flag, so
//   the decision is the whole tile's, taken once, and costs the common
//   tile (all groups in range) no wait at all.
// - Determinism. Which rows a group sums does not depend on timing, and
//   at the end the groups' partial sums are added in group order.
//
// The valid entries of a table row are a closest-first prefix
// (ops/neighbors.py), so a block streams its first count[b] slots.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_groups.cuh"
#include "pair_math.cuh"

namespace {

using csf::Cta;
using csf::kRecv;
using csf::kSrcCols;

// The ring's slots, measured on an H100 (PERF.md); the CTA's shape (thread
// groups per receiver block, the CTAs an SM must hold at once for
// __launch_bounds__) is csf::Cta<kBlock>.
constexpr int kDepth = 4;

// The ring of a receiver block of kBlock agents: tiles of kBlock source
// rows, each group on kStripRows rows of every tile.
template <int kBlock>
struct Ring {
  static constexpr int kStripRows = kBlock / Cta<kBlock>::kGroups;
  static constexpr int kTileVec = kBlock * kSrcCols / 4;   // float4 per tile
  static constexpr unsigned kTileBytes = kTileVec * sizeof(float4);
  static_assert(kBlock % Cta<kBlock>::kGroups == 0, "equal strips");
  // dynamic shared memory: the ring's tiles, the groups' partial sums
  // [kGroups][2][kBlock], then per slot two mbarriers, a count and a flag
  // (40 KB at block 128, 72 KB at block 256)
  static constexpr size_t kPartOffset = sizeof(float4) * kDepth * kTileVec;
  static constexpr size_t kBarOffset =
      kPartOffset + sizeof(float) * Cta<kBlock>::kGroups * 2 * kBlock;
  static constexpr size_t kBytes =
      kBarOffset + kDepth * (2 * sizeof(uint64_t) + sizeof(unsigned) +
                             sizeof(int));
};

template <int kBlock, bool kFov, bool kP2R, bool kMixed>
__global__ void __launch_bounds__(Cta<kBlock>::kThreads,
                                  Cta<kBlock>::kMinBlocks)
pair_forces_db_kernel(const int* __restrict__ nbr,
                      const int* __restrict__ count,
                      const float* __restrict__ src,
                      const float* __restrict__ recv,
                      float* __restrict__ out, int kb, float cutoff2) {
  using C = Cta<kBlock>;
  using R = Ring<kBlock>;
  constexpr int kWarps = C::kThreads / 32;
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  float4* const ring4 = smem4;
  float* const part = reinterpret_cast<float*>(smem + R::kPartOffset);
  uint64_t* const full =                  // tile landed in the slot
      reinterpret_cast<uint64_t*>(smem + R::kBarOffset);
  uint64_t* const voted = full + kDepth;  // every group voted on the slot's tile
  unsigned* const done =                  // warps finished with the slot
      reinterpret_cast<unsigned*>(voted + kDepth);
  int* const admit =                      // some group found a pair in range
      reinterpret_cast<int*>(done + kDepth);

  const int b = blockIdx.x;
  const int g = threadIdx.x / C::kGroupThreads;
  const int lt = threadIdx.x % C::kGroupThreads;
  const int bar = csf::group_barrier(g);
  const int npad = gridDim.x * kBlock;
  const int n_slots = count[b];

  // one thread: start the copy of tile k into `slot`
  auto fill = [&](int slot, int k) {
    csf::bulk_copy(ring4 + slot * R::kTileVec,
                   reinterpret_cast<const float4*>(src) +
                       (size_t)nbr[b * kb + k] * R::kTileVec,
                   R::kTileBytes, &full[slot]);
  };

  if (threadIdx.x < kDepth) {
    csf::mbar_init(&full[threadIdx.x], 1);
    csf::mbar_init(&voted[threadIdx.x], C::kGroups);
    done[threadIdx.x] = 0;
    admit[threadIdx.x] = 0;
    csf::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < kDepth && threadIdx.x < n_slots) {
    fill(threadIdx.x, threadIdx.x);
  }

  csf::Receiver rc[kRecv];
  float fx[kRecv], fy[kRecv];
  csf::load_receivers<kBlock>(recv, npad, b, lt, rc, fx, fy);
  const csf::FieldConsts unused{};

  for (int k = 0; k < n_slots; ++k) {
    const int slot = k % kDepth;
    const unsigned parity = (k / kDepth) & 1;
    const float4* const strip =
        ring4 + slot * R::kTileVec + g * R::kStripRows * (kSrcCols / 4);
    csf::mbar_wait(&full[slot], parity);

    // the tile screen: this group's strip first, the other groups' word
    // only if the strip has no pair in range
    bool go = csf::group_in_range<kBlock>(strip, 0, R::kStripRows, lt, rc,
                                          cutoff2, bar);
    if (lt == 0) {
      if (go) admit[slot] = 1;
      csf::mbar_arrive(&voted[slot]);
    }
    if (!go) {
      csf::mbar_wait(&voted[slot], parity);
      go = *static_cast<volatile int*>(&admit[slot]) != 0;
    }
    if (go) {
      const float4* const end = strip + R::kStripRows * (kSrcCols / 4);
      // one source row per trip: the kRecv receivers are each thread's
      // independent chains
#pragma unroll 1
      for (const float4* q = strip; q < end; q += kSrcCols / 4) {
        const csf::SrcRow row = csf::load_row<false, kMixed>(q);
        csf::add_pairs<false, kFov, kP2R, kMixed>(row, rc, unused, fx, fy);
      }
    }

    // this warp is done with the slot; the last of the CTA's warps to say
    // so hands the slot to tile k + kDepth
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      __threadfence_block();
      if (atomicInc(&done[slot], kWarps - 1) == kWarps - 1 &&
          k + kDepth < n_slots) {
        __threadfence_block();
        admit[slot] = 0;
        fill(slot, k + kDepth);
      }
    }
  }

  csf::sum_groups<kBlock>(part, g, lt, rc, fx, fy, out, npad, b);
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the
// first count[b] entries of row b are valid source block indices, blocks
// of `block` sources); src [N_src, 16] float32, 16-byte aligned, N_src a
// multiple of `block`; recv [8, n_blocks * block] float32; out [2, n_blocks
// * block] float32; `block` is 64, 128 or 256, for receivers and sources
// alike; cutoff2 the squared cutoff of the tile screen; `mixed` selects
// each row's family by its column 13. Returns cudaGetLastError() after the
// launch (0 on success; cudaErrorInvalidValue, with no launch, for a block
// the kernel is not compiled for).
int csf_pair_forces_db(const void* nbr, const void* count, const void* src,
                       const void* recv, void* out, int n_blocks, int kb,
                       int block, int mixed, int fov, int p2r, float cutoff2,
                       int device, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const bool known = csf::with_block(block, [&](auto B) {
    constexpr int kBlock = decltype(B)::value;
    constexpr size_t smem = Ring<kBlock>::kBytes;
    csf::with_flag(fov, [&](auto FV) {
      csf::with_flag(p2r, [&](auto P2R) {
        csf::with_flag(mixed, [&](auto M) {
          auto kernel =
              pair_forces_db_kernel<kBlock, decltype(FV)::value,
                                    decltype(P2R)::value, decltype(M)::value>;
          if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return;
          }
          kernel<<<n_blocks, Cta<kBlock>::kThreads, smem, s>>>(
              static_cast<const int*>(nbr), static_cast<const int*>(count),
              static_cast<const float*>(src),
              static_cast<const float*>(recv), static_cast<float*>(out), kb,
              cutoff2);
          err = cudaGetLastError();
        });
      });
    });
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // extern "C"
