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
// - Every group works on every tile. A receiver block is one CTA of
//   kGroups groups of 64 threads, 2 receivers per thread
//   (pair_groups.cuh); group g takes rows [16 g, 16 g + 16) of each tile
//   for all 128 receivers, so the groups' shares are equal whatever the
//   row's count, and 2 CTAs (32 warps) fit an SM beside the 2 x 32 KB of
//   rings.
// - A ring without CTA-wide barriers. Each slot has a "full" mbarrier,
//   which the tile's bulk copy (cp.async.bulk, issued by one thread)
//   completes and on whose parity the consumers wait, and a count of the
//   warps that are done with the slot. The warp that brings the count to
//   16 -- the last reader, whichever it is -- resets it and issues the
//   copy of tile k + 4 into the slot at once; nobody waits for the slot to
//   empty, and up to 3 further tiles are already resident or in flight.
// - The screen vote. A tile is admitted iff some pair of its 128 rows and
//   the block's 128 receivers lies within the cutoff (the plain version's
//   test; its minimum covers inactive and pad rows). Each group votes on
//   its own strip with one barrier reduction over its 64 threads
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

using csf::kBlock;
using csf::kGroupThreads;
using csf::kRecv;
using csf::kSrcCols;

// The shape of a CTA, measured on an H100 (PERF.md): thread groups per
// receiver block, the CTAs an SM must hold at once (__launch_bounds__: 2
// CTAs of 512 threads, 64 registers), and the ring's slots.
constexpr int kGroups = 8;
constexpr int kMinBlocks = 2;
constexpr int kDepth = 4;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kStripRows = kBlock / kGroups;        // a group's rows of a tile
constexpr int kTileVec = kBlock * kSrcCols / 4;     // float4 per tile
constexpr unsigned kTileBytes = kTileVec * sizeof(float4);

static_assert(kGroups <= 15, "one named barrier per group");
static_assert(kBlock % kGroups == 0, "equal strips");

template <bool kFov, bool kP2R, bool kMixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_forces_db_kernel(const int* __restrict__ nbr,
                      const int* __restrict__ count,
                      const float* __restrict__ src,
                      const float* __restrict__ recv,
                      float* __restrict__ out, int kb, float cutoff2) {
  __shared__ float4 ring4[kDepth * kTileVec];
  __shared__ float part[kGroups * 2 * kBlock];
  __shared__ uint64_t full[kDepth];     // tile landed in the slot
  __shared__ uint64_t voted[kDepth];    // every group voted on the slot's tile
  __shared__ unsigned done[kDepth];     // warps finished with the slot
  __shared__ int admit[kDepth];         // some group found a pair in range

  const int b = blockIdx.x;
  const int g = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int bar = csf::group_barrier(g);
  const int npad = gridDim.x * kBlock;
  const int n_slots = count[b];

  // one thread: start the copy of tile k into `slot`
  auto fill = [&](int slot, int k) {
    csf::bulk_copy(ring4 + slot * kTileVec,
                   reinterpret_cast<const float4*>(src) +
                       (size_t)nbr[b * kb + k] * kTileVec,
                   kTileBytes, &full[slot]);
  };

  if (threadIdx.x < kDepth) {
    csf::mbar_init(&full[threadIdx.x], 1);
    csf::mbar_init(&voted[threadIdx.x], kGroups);
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
  csf::load_receivers(recv, npad, b, lt, rc, fx, fy);
  const csf::FieldConsts unused{};

  for (int k = 0; k < n_slots; ++k) {
    const int slot = k % kDepth;
    const unsigned parity = (k / kDepth) & 1;
    const float4* const strip =
        ring4 + slot * kTileVec + g * kStripRows * (kSrcCols / 4);
    csf::mbar_wait(&full[slot], parity);

    // the tile screen: this group's strip first, the other groups' word
    // only if the strip has no pair in range
    bool go = csf::group_in_range(strip, 0, kStripRows, lt, rc, cutoff2, bar);
    if (lt == 0) {
      if (go) admit[slot] = 1;
      csf::mbar_arrive(&voted[slot]);
    }
    if (!go) {
      csf::mbar_wait(&voted[slot], parity);
      go = *static_cast<volatile int*>(&admit[slot]) != 0;
    }
    if (go) {
      const float4* const end = strip + kStripRows * (kSrcCols / 4);
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

  csf::sum_groups<kGroups>(part, g, lt, rc, fx, fy, out, npad, b);
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the
// first count[b] entries of row b are valid source block indices, blocks
// of 128 sources); src [N_src, 16] float32, 16-byte aligned, N_src a
// multiple of 128; recv [8, n_blocks * 128] float32; out [2, n_blocks *
// 128] float32; cutoff2 the squared cutoff of the tile screen; `mixed`
// selects each row's family by its column 13. Returns cudaGetLastError()
// after the launch (0 on success).
int csf_pair_forces_db(const void* nbr, const void* count, const void* src,
                       const void* recv, void* out, int n_blocks, int kb,
                       int mixed, int fov, int p2r, float cutoff2, int device,
                       void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  csf::with_flag(fov, [&](auto FV) {
    csf::with_flag(p2r, [&](auto P2R) {
      csf::with_flag(mixed, [&](auto M) {
        pair_forces_db_kernel<decltype(FV)::value, decltype(P2R)::value,
                              decltype(M)::value>
            <<<n_blocks, kThreads, 0, s>>>(
                static_cast<const int*>(nbr), static_cast<const int*>(count),
                static_cast<const float*>(src),
                static_cast<const float*>(recv), static_cast<float*>(out),
                kb, cutoff2);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
