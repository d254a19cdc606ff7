// Block-sparse pairwise repulsive-force sum, every source tile of a
// receiver block staged in shared memory before it is used.
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel_unrolled (one program per receiver block; all KB source
// tile copies issued first into a KB-deep scratch, then a statically
// unrolled accumulate with no distance screen), in each of its forms:
// `uniform` or per-source field parameters, the mixed-family form (each
// row's own field, twod or legacy, by its column 13), FOV cone on or off,
// priority to the right on or off. The per-pair math is csf::add_pairs
// (pair_math.cuh), the thread groups' shared pieces are in
// pair_groups.cuh; both are shared with pair_forces.cu.
//
// What bounds it. The same ~8.8e7 pair evaluations per call as
// pair_forces.cu at the main path's shape (100k agents, block_src = 64,
// kb = 19) and the same per-pair code: 5 MUFU operations and ~66
// instructions per twod pair, so instruction issue bounds it (0.17 ms on
// an H100, above the MUFU floor of 0.105 ms and the FP32 floor); the
// bytes (a 4 KB tile per slot, from L2) are small. What is particular to
// this kernel is its shared memory: with every tile resident, the
// footprint decides how many warps an SM holds, and a thread that waits
// for the last tile before its first pair wastes the copies' latency.
//
// Design, against each of those costs:
// - Warps per SM. A receiver block of kBlock agents (64, 128 or 256) is
//   one CTA of kGroups groups of kBlock / 2 threads, 2 receivers per thread
//   (csf::Cta, pair_groups.cuh). The tiles are staged in rounds of at most
//   kStageBytes: with the groups' partial sums that is ~105 KB, so at block
//   128 and 256 two CTAs (32 warps, all 64 K registers) fit an SM at any kb;
//   at block 64 the same two CTAs hold 16 warps. The main path's row (kb 19, 76 KB) is one round; the
//   legacy field's (kb ~35 at cutoff 100 m, 140 KB) is two, where staging
//   it whole would leave one CTA per SM.
// - Tiles land once, compute starts with the first. At the start of a
//   round one thread per tile hands its copy to the copy engine
//   (cp.async.bulk), each tile with its own mbarrier. A group waits only
//   for the tiles it reads, each when it first reaches it; there is no
//   barrier between slots, and none across the CTA but one between
//   rounds (before a round's tiles are overwritten).
// - Even shares. With all tiles of a round resident, the groups split
//   its source rows evenly, whatever the row's count: group g takes rows
//   [g n / kGroups, (g + 1) n / kGroups) of the round's n rows, for all
//   kBlock receivers. (pair_forces.cu hands out whole tiles, so a row of 14
//   tiles keeps some of its groups waiting for a quarter of the time.)
// - Determinism. The split depends only on the row's count; at the end
//   the groups' partial sums are added in group order (no atomics).
//
// The valid entries of a table row are a closest-first prefix
// (ops/neighbors.py), so a block stages its first count[b] slots.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_groups.cuh"
#include "pair_math.cuh"

namespace {

using csf::Cta;
using csf::kRecv;
using csf::kSrcCols;

// The bytes of source tiles a round stages, measured on an H100 (PERF.md);
// the CTA's shape (thread groups per receiver block, the CTAs an SM must
// hold at once for __launch_bounds__) is csf::Cta<kBlock>.
constexpr int kStageBytes = 96 * 1024;

// tiles a round stages for a table of kb slots
int round_slots(int kb, int block_src) {
  const int fit = kStageBytes / (block_src * kSrcCols * (int)sizeof(float));
  return kb < fit ? kb : fit;
}

// dynamic shared memory of a launch: the round's tiles, the groups'
// partial sums [kGroups][2][kBlock], one mbarrier per staged tile
template <int kBlock>
size_t shared_bytes(int slots, int block_src) {
  return sizeof(float) * (slots * kSrcCols * (size_t)block_src +
                          Cta<kBlock>::kGroups * 2 * kBlock) +
         sizeof(uint64_t) * slots;
}

template <int kBlock, bool kUniform, bool kFov, bool kP2R, bool kMixed>
__global__ void __launch_bounds__(Cta<kBlock>::kThreads,
                                  Cta<kBlock>::kMinBlocks)
pair_forces_unrolled_kernel(const int* __restrict__ nbr,
                            const int* __restrict__ count,
                            const float* __restrict__ src,
                            const float* __restrict__ recv,
                            float* __restrict__ out, int kb, int block_src,
                            int slots, csf::TwodParams tp) {
  using C = Cta<kBlock>;
  constexpr int kGroups = C::kGroups;
  constexpr int kThreads = C::kThreads;
  extern __shared__ float4 smem4[];

  const int b = blockIdx.x;
  const int g = threadIdx.x / C::kGroupThreads;
  const int lt = threadIdx.x % C::kGroupThreads;
  const int npad = gridDim.x * kBlock;
  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);
  const unsigned tile_bytes = tile_vec * sizeof(float4);
  float4* const tiles = smem4;
  float* const part = reinterpret_cast<float*>(smem4 + slots * tile_vec);
  uint64_t* const landed =
      reinterpret_cast<uint64_t*>(part + kGroups * 2 * kBlock);

  for (int s = threadIdx.x; s < slots; s += kThreads) {
    csf::mbar_init(&landed[s], 1);
  }
  csf::mbar_init_fence();
  __syncthreads();

  csf::Receiver rc[kRecv];
  float fx[kRecv], fy[kRecv];
  csf::load_receivers<kBlock>(recv, npad, b, lt, rc, fx, fy);
  const csf::FieldConsts p = csf::field_consts(tp);

  for (int k0 = 0; k0 < n_slots; k0 += slots) {
    const int n = min(slots, n_slots - k0);        // this round's tiles
    const unsigned parity = (k0 / slots) & 1;
    // a round's tiles are overwritten only after every group is done
    // with them
    if (k0 > 0) __syncthreads();
    for (int s = threadIdx.x; s < n; s += kThreads) {
      csf::bulk_copy(tiles + s * tile_vec,
                     reinterpret_cast<const float4*>(src) +
                         (size_t)nbr[b * kb + k0 + s] * tile_vec,
                     tile_bytes, &landed[s]);
    }
    // this group's share of the round's rows, tile by tile
    const int rows = n * block_src;
    const int hi = rows * (g + 1) / kGroups;
    for (int j = rows * g / kGroups; j < hi;) {
      const int s = j / block_src;
      const int stop = min(hi, (s + 1) * block_src);
      csf::mbar_wait(&landed[s], parity);
      const float4* const end = tiles + stop * 4;
      // one source row per trip: the kRecv receivers are each thread's
      // independent chains
#pragma unroll 1
      for (const float4* q = tiles + j * 4; q < end; q += 4) {
        const csf::SrcRow row = csf::load_row<kUniform, kMixed>(q);
        csf::add_pairs<kUniform, kFov, kP2R, kMixed>(row, rc, p, fx, fy);
      }
      j = stop;
    }
  }

  csf::sum_groups<kBlock>(part, g, lt, rc, fx, fy, out, npad, b);
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`; arguments as for
// csf_pair_forces_twod (pair_forces.cu), without the screen. Any kb is
// taken: a row longer than a round is staged in several. Returns
// cudaGetLastError() after the launch (0 on success; cudaErrorInvalidValue,
// with no launch, for arguments the kernel does not take).
int csf_pair_forces_unrolled(const void* nbr, const void* count,
                             const void* src, const void* recv, void* out,
                             int n_blocks, int kb, int block, int block_src,
                             int uniform, int mixed, int fov, int p2r,
                             float e0, float e1, float s0, float s1,
                             float s2, float s3, float chf, int device,
                             void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_src <= 0 || block % block_src != 0 || kb <= 0 ||
      (uniform && mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slots = round_slots(kb, block_src);

  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  auto s = static_cast<cudaStream_t>(stream);
  const bool known = csf::with_block(block, [&](auto B) {
    constexpr int kBlock = decltype(B)::value;
    const size_t smem = shared_bytes<kBlock>(slots, block_src);
    csf::with_flag(uniform, [&](auto U) {
      csf::with_flag(fov, [&](auto FV) {
        csf::with_flag(p2r, [&](auto P2R) {
          csf::with_flag(mixed, [&](auto M) {
            if constexpr (!(decltype(U)::value && decltype(M)::value)) {
              auto kernel = pair_forces_unrolled_kernel<
                  kBlock, decltype(U)::value, decltype(FV)::value,
                  decltype(P2R)::value, decltype(M)::value>;
              err = cudaFuncSetAttribute(
                  kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  static_cast<int>(smem));
              if (err != cudaSuccess) return;
              kernel<<<n_blocks, Cta<kBlock>::kThreads, smem, s>>>(
                  static_cast<const int*>(nbr),
                  static_cast<const int*>(count),
                  static_cast<const float*>(src),
                  static_cast<const float*>(recv), static_cast<float*>(out),
                  kb, block_src, slots, p);
              err = cudaGetLastError();
            }
          });
        });
      });
    });
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // extern "C"
