// Block-sparse pairwise repulsive-force sum of the BMD2023 "twod" field or,
// in the mixed-family form, of each source row's own field (twod or the
// legacy v0.1 elliptic field).
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel (grid (receiver block, table slot), tile math
// _tile_forces) in each of its forms: shared field parameters baked in as
// arguments or read per source row (`uniform`), the mixed-family form
// (`mixed`, per-row columns), the FOV cone on or off, the
// priority-to-the-right mask, and no distance screen, the tile screen or
// the strip screen (`screen`, `sub`). The per-pair math is csf::add_pairs
// (pair_math.cuh), the thread groups' shared pieces are in
// pair_groups.cuh.
//
// What bounds it. At the main path's configuration (100k agents,
// block_src = 64, kb = 19) a call evaluates 8.8e7 pairs; the bytes are
// small (a 4 KB source tile per slot, read from L2). A twod pair with the
// FOV cone needs 72 FP32 operations and at least 5 MUFU (special function
// unit) operations: on an H100 (132 SMs at 1.98 GHz, 128 FP32 lanes and
// 16 MUFU results per clock per SM) 0.094 ms of FP32 and 0.105 ms of
// MUFU, so the MUFU is the floor. As compiled, a twod pair here is those
// 5 MUFU and ~66 instructions in all (FP32, compares, loads, loop), and
// each SM sub-partition issues one warp instruction per clock: 0.17 ms of
// issue, above both floors, so instruction issue bounds the kernel. A
// legacy row (bicycle2d's default field, cutoff ~100 m, kb ~35, ~2x the
// pairs) takes 2 MUFU and ~40 FP32 operations. The work is a dependent
// chain of FP32 and MUFU operations per pair with no matrix product in
// it, so the tensor cores do not apply.
//
// Design, against each of those costs:
// - Instructions per pair. The decision chain of the field (pair_math.cuh)
//   keeps the plain version's rounding; the smooth rest uses explicit
//   fmaf, the MUFU's approximate rsqrt and ex2 with no subnormal guards,
//   and one rsqrt for the exponent's sqrt(rho2 ec2) / sigma (5 MUFU per
//   twod pair, not 6). The tracked mask stays a predicate, the receiver's
//   activity is applied to its sum once, and the uniform constants are
//   prepared once per thread.
// - Issue efficiency. A receiver block of kBlock agents (64, 128 or 256, a
//   template parameter) is one CTA of kGroups groups of kBlock / kRecv
//   threads (csf::Cta). Each thread holds kRecv receivers as independent
//   chains fed by one broadcast read of each source row, and group g takes
//   table slots g, g + kGroups, ... for all kBlock receivers.
//   More independent work per warp hides the MUFU and shared-memory
//   latencies, and the CTAs are short enough (~2 slots per group on the
//   main path) that the SMs stay evenly loaded to the end of the call.
// - Staging. Each group copies its slot's [block_src, 16] tile into its
//   own shared memory with cp.async and synchronises on its own named
//   barrier, so the groups never wait for each other; while one group
//   waits for its copy, the others compute. A second tile per group (a
//   2-stage ring, the next copy under the current math) measured no
//   faster at block_src 64 and slower at 128, where its shared memory
//   halves the CTAs per SM.
// - Determinism. At the end the groups' partial sums meet in shared memory
//   and are added in group order: no atomics, the same result every run.
//
// The valid entries of a table row are a closest-first prefix
// (ops/neighbors.py), so a block runs over `count[b]` slots; the TPU's
// sign-sentinel flat table (an SMEM layout workaround) is not needed.
//
// Distance screen. With `screen`, each strip of `strip` sources (the
// whole tile, or `sub` rows) is skipped when no pair of it and the block's
// receivers lies within the cutoff, the plain version's test (its
// minimum covers inactive and pad rows, as the TPU kernel's does, so all
// three skip the same strips). The group votes with a barrier reduction
// (bar.red.or) over its threads, which hold all the block's receivers: first on
// one probe pair per receiver, which admits most strips at once, then,
// if no probe was in range, on every pair of the strip
// (csf::group_in_range).

#include <cuda_runtime.h>

#include "pair_groups.cuh"
#include "pair_math.cuh"

namespace {

using csf::Cta;
using csf::kRecv;
using csf::kSrcCols;

// dynamic shared memory of a launch: each group's tile, then the groups'
// partial sums [kGroups][2][kBlock]
template <int kBlock>
size_t shared_bytes(int block_src) {
  constexpr int kGroups = Cta<kBlock>::kGroups;
  return sizeof(float) * (kGroups * kSrcCols * (size_t)block_src +
                          kGroups * 2 * kBlock);
}

// The CTA's shape (thread groups per receiver block, of kBlock / kRecv
// threads, kRecv receivers per thread, and the CTAs an SM must hold at
// once for __launch_bounds__) is csf::Cta<kBlock>, measured on an H100 at
// block 128 (PERF.md).
template <int kBlock, bool kUniform, bool kFov, bool kP2R, bool kScreen,
          bool kMixed>
__global__ void __launch_bounds__(Cta<kBlock>::kThreads,
                                  Cta<kBlock>::kMinBlocks)
pair_forces_twod_kernel(const int* __restrict__ nbr,
                        const int* __restrict__ count,
                        const float* __restrict__ src,
                        const float* __restrict__ recv,
                        float* __restrict__ out, int kb, int block_src,
                        int strip, float cutoff2, csf::TwodParams tp) {
  using C = Cta<kBlock>;
  constexpr int kGroups = C::kGroups;
  constexpr int kGroupThreads = C::kGroupThreads;
  extern __shared__ float4 smem4[];

  const int b = blockIdx.x;
  const int g = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int bar = csf::group_barrier(g);
  const int npad = gridDim.x * kBlock;
  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);
  float4* const tile = smem4 + g * tile_vec;     // this group's tile

  // start copying slot k's tile into this group's tile (none past the
  // row's count)
  auto fill = [&](int k) {
    if (k >= n_slots) return;
    const float4* gsrc = reinterpret_cast<const float4*>(src) +
                         (size_t)nbr[b * kb + k] * tile_vec;
    for (int i = lt; i < tile_vec; i += kGroupThreads) {
      csf::cp_async16(tile + i, gsrc + i);
    }
    csf::cp_async_commit();
  };
  fill(g);

  csf::Receiver rc[kRecv];
  float fx[kRecv], fy[kRecv];
  csf::load_receivers<kBlock>(recv, npad, b, lt, rc, fx, fy);
  const csf::FieldConsts p = csf::field_consts(tp);

  for (int k = g; k < n_slots; k += kGroups) {
    csf::cp_async_wait<0>();
    csf::group_sync<kGroupThreads>(bar);
    for (int j0 = 0; j0 < block_src; j0 += strip) {
      if constexpr (kScreen) {
        if (!csf::group_in_range<kBlock>(tile, j0, strip, lt, rc, cutoff2,
                                         bar)) {
          continue;
        }
      }
      const float4* const end = tile + (j0 + strip) * 4;
      // one source row per trip (the build measured in PERF.md): the
      // kRecv receivers are each thread's independent chains
#pragma unroll 1
      for (const float4* q = tile + j0 * 4; q < end; q += 4) {
        const csf::SrcRow row = csf::load_row<kUniform, kMixed>(q);
        csf::add_pairs<kUniform, kFov, kP2R, kMixed>(row, rc, p, fx, fy);
      }
    }
    // the next copy overwrites the tile only after every thread of the
    // group is done with it
    csf::group_sync<kGroupThreads>(bar);
    fill(k + kGroups);
  }

  csf::sum_groups<kBlock>(reinterpret_cast<float*>(smem4 + kGroups * tile_vec),
                          g, lt, rc, fx, fy, out, npad, b);
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the
// first count[b] entries of row b are valid source block indices); src
// [N_src, 16] float32, 16-byte aligned, N_src a multiple of block_src; recv
// [8, n_blocks * block] float32; out [2, n_blocks * block] float32. `block`
// is the receiver block, 64, 128 or 256; block_src must divide it. `strip`
// is the screened source strip (block_src for the tile screen; it must
// divide block_src), `cutoff2` the squared cutoff the screen compares with;
// both are ignored without `screen`. e0..chf are the shared field
// parameters (read only with `uniform`); `mixed` selects each row's family
// by its column 13 and excludes `uniform`. Returns cudaGetLastError() after
// the launch (0 on success; cudaErrorInvalidValue, with no launch, for
// arguments the kernel does not take).
int csf_pair_forces_twod(const void* nbr, const void* count,
                         const void* src, const void* recv, void* out,
                         int n_blocks, int kb, int block, int block_src,
                         int uniform, int mixed, int fov, int p2r, int screen,
                         int strip, float cutoff2, float e0, float e1,
                         float s0, float s1, float s2, float s3, float chf,
                         int device, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!screen) strip = block_src;
  if (block_src <= 0 || block % block_src != 0 || strip <= 0 ||
      block_src % strip != 0 || (uniform && mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  auto s = static_cast<cudaStream_t>(stream);
  const bool known = csf::with_block(block, [&](auto B) {
    constexpr int kBlock = decltype(B)::value;
    // at most 72 KB (block 256, block_src = 256), above the 48 KB a kernel
    // gets unasked
    const size_t smem = shared_bytes<kBlock>(block_src);
    csf::with_flag(uniform, [&](auto U) {
      csf::with_flag(fov, [&](auto FV) {
        csf::with_flag(p2r, [&](auto P2R) {
          csf::with_flag(screen, [&](auto SCR) {
            csf::with_flag(mixed, [&](auto M) {
              if constexpr (!(decltype(U)::value && decltype(M)::value)) {
                auto kernel = pair_forces_twod_kernel<
                    kBlock, decltype(U)::value, decltype(FV)::value,
                    decltype(P2R)::value, decltype(SCR)::value,
                    decltype(M)::value>;
                if (smem > 48 * 1024) {
                  err = cudaFuncSetAttribute(
                      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                      static_cast<int>(smem));
                  if (err != cudaSuccess) return;
                }
                kernel<<<n_blocks, Cta<kBlock>::kThreads, smem, s>>>(
                    static_cast<const int*>(nbr),
                    static_cast<const int*>(count),
                    static_cast<const float*>(src),
                    static_cast<const float*>(recv), static_cast<float*>(out),
                    kb, block_src, strip, cutoff2, p);
                err = cudaGetLastError();
              }
            });
          });
        });
      });
    });
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

const char* csf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
