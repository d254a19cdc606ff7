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
// the strip screen (`screen`, `sub`). The per-pair math is csf::k1_pairs
// (pair_math.cuh).
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
// - Issue efficiency. A receiver block of 128 agents is one CTA of kGroups
//   groups of 128 / kRecv threads. Each thread holds kRecv receivers as
//   independent chains fed by one broadcast read of each source row, and
//   group g takes table slots g, g + kGroups, ... for all 128 receivers.
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
// 128 receivers lies within the cutoff, the plain version's test (its
// minimum covers inactive and pad rows, as the TPU kernel's does, so all
// three skip the same strips). The group votes with a barrier reduction
// (bar.red.or) over its threads, which hold all 128 receivers: first on
// one probe pair per receiver, which admits most strips at once, then,
// if no probe was in range, on every pair of the strip.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

using csf::kBlock;
using csf::kSrcCols;

// The shape of a CTA, measured on an H100 (PERF.md): thread groups per
// receiver block, receivers per thread, and the CTAs an SM must hold at
// once (__launch_bounds__, which caps the registers: 2 CTAs of 512
// threads, 64 registers).
constexpr int kGroups = 8;
constexpr int kRecv = 2;
constexpr int kMinBlocks = 2;
constexpr int kGroupThreads = kBlock / kRecv;
constexpr int kThreads = kGroups * kGroupThreads;

static_assert(kGroupThreads % 32 == 0, "a group is whole warps");
static_assert(kGroups <= 15, "one named barrier per group");

// wait for the threads of this thread's group (named barrier `id`)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kGroupThreads)
               : "memory");
}

// is `v` true on any thread of this thread's group?
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

// dynamic shared memory of a launch: each group's tile, then the groups'
// partial sums [kGroups][2][kBlock]
size_t shared_bytes(int block_src) {
  return sizeof(float) * (kGroups * kSrcCols * (size_t)block_src +
                          kGroups * 2 * kBlock);
}

template <bool kUniform, bool kFov, bool kP2R, bool kScreen, bool kMixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_forces_twod_kernel(const int* __restrict__ nbr,
                        const int* __restrict__ count,
                        const float* __restrict__ src,
                        const float* __restrict__ recv,
                        float* __restrict__ out, int kb, int block_src,
                        int strip, float cutoff2, csf::TwodParams tp) {
  extern __shared__ float4 smem4[];

  const int b = blockIdx.x;
  const int g = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int bar = 1 + g;                 // barrier 0 is __syncthreads'
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
#pragma unroll
  for (int i = 0; i < kRecv; ++i) {
    rc[i] = csf::load_receiver(recv, npad,
                               b * kBlock + lt + i * kGroupThreads);
    fx[i] = 0.0f;
    fy[i] = 0.0f;
  }
  const csf::K1Uniform p = csf::k1_uniform(tp);

  for (int k = g; k < n_slots; k += kGroups) {
    csf::cp_async_wait<0>();
    group_sync(bar);
    for (int j0 = 0; j0 < block_src; j0 += strip) {
      if constexpr (kScreen) {
        // admitted iff some pair lies within the cutoff: first a probe of
        // one pair per receiver (receiver rr against row rr mod strip),
        // which settles most strips, then every pair
        const float4 a = tile[(j0 + lt % strip) * 4];
        bool near = false;
#pragma unroll
        for (int i = 0; i < kRecv; ++i) {
          near |= csf::k1_rho2(a.x, a.y, rc[i]) <= cutoff2;
        }
        if (!group_any(near, bar)) {
          float rho2_min = INFINITY;
          for (int j = j0; j < j0 + strip; ++j) {
            const float4 q = tile[j * 4];
#pragma unroll
            for (int i = 0; i < kRecv; ++i) {
              rho2_min = fminf(rho2_min, csf::k1_rho2(q.x, q.y, rc[i]));
            }
          }
          if (!group_any(rho2_min <= cutoff2, bar)) continue;
        }
      }
      const float4* const end = tile + (j0 + strip) * 4;
      // one source row per trip (the build measured in PERF.md): the
      // kRecv receivers are each thread's independent chains
#pragma unroll 1
      for (const float4* q = tile + j0 * 4; q < end; q += 4) {
        const csf::K1Row row = csf::k1_load_row<kUniform, kMixed>(q);
        csf::k1_pairs<kUniform, kFov, kP2R, kMixed>(row, rc, p, fx, fy);
      }
    }
    // the next copy overwrites the tile only after every thread of the
    // group is done with it
    group_sync(bar);
    fill(k + kGroups);
  }

  // the groups' partial sums, added in group order; an inactive receiver
  // gets 0 (the plain version's mask drops each of its pairs)
  float* part = reinterpret_cast<float*>(smem4 + kGroups * tile_vec);
#pragma unroll
  for (int i = 0; i < kRecv; ++i) {
    const int rr = lt + i * kGroupThreads;
    part[(2 * g) * kBlock + rr] = rc[i].act ? fx[i] : 0.0f;
    part[(2 * g + 1) * kBlock + rr] = rc[i].act ? fy[i] : 0.0f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * kBlock; o += kThreads) {
    const int c = o / kBlock, rr = o % kBlock;     // c: 0 fx, 1 fy
    float sum = part[c * kBlock + rr];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) sum += part[(2 * q + c) * kBlock + rr];
    out[c * npad + b * kBlock + rr] = sum;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the
// first count[b] entries of row b are valid source block indices); src
// [N_src, 16] float32, 16-byte aligned, N_src a multiple of block_src; recv
// [8, n_blocks * 128] float32; out [2, n_blocks * 128] float32. `strip` is
// the screened source strip (block_src for the tile screen; it must divide
// block_src), `cutoff2` the squared cutoff the screen compares with; both
// are ignored without `screen`. e0..chf are the shared field parameters
// (read only with `uniform`); `mixed` selects each row's family by its
// column 13 and excludes `uniform`. Returns csf::kErrSharedMemory when the
// launch needs more shared memory than the device's opt-in limit, else
// cudaGetLastError() after the launch (0 on success).
int csf_pair_forces_twod(const void* nbr, const void* count,
                         const void* src, const void* recv, void* out,
                         int n_blocks, int kb, int block_src, int uniform,
                         int mixed, int fov, int p2r, int screen, int strip,
                         float cutoff2, float e0, float e1, float s0,
                         float s1, float s2, float s3, float chf, int device,
                         void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!screen) strip = block_src;
  if (block_src <= 0 || kBlock % block_src != 0 || strip <= 0 ||
      block_src % strip != 0 || (uniform && mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(block_src);
  if (smem > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(optin)) return csf::kErrSharedMemory;
  }
  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  auto s = static_cast<cudaStream_t>(stream);
  csf::with_flag(uniform, [&](auto U) {
    csf::with_flag(fov, [&](auto FV) {
      csf::with_flag(p2r, [&](auto P2R) {
        csf::with_flag(screen, [&](auto SCR) {
          csf::with_flag(mixed, [&](auto M) {
            if constexpr (!(decltype(U)::value && decltype(M)::value)) {
              auto kernel = pair_forces_twod_kernel<
                  decltype(U)::value, decltype(FV)::value,
                  decltype(P2R)::value, decltype(SCR)::value,
                  decltype(M)::value>;
              if (smem > 48 * 1024) {
                err = cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    static_cast<int>(smem));
                if (err != cudaSuccess) return;
              }
              kernel<<<n_blocks, kThreads, smem, s>>>(
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
  return static_cast<int>(err);
}

const char* csf_error_string(int code) {
  if (code == csf::kErrSharedMemory) {
    return "the launch needs more dynamic shared memory than the device's "
           "opt-in limit per block";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
