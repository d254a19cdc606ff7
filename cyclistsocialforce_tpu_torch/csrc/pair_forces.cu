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
// the strip screen (`screen`, `sub`). The per-pair math is
// csf::pair_accumulate (pair_math.cuh).
//
// Design. One CTA per receiver block of 128 agents, one thread per
// receiver: each receiver is owned by exactly one thread, so the sum needs
// no atomics and no cross-block reduction, and the TPU's sequential
// accumulation over table slots becomes a loop inside the CTA. The valid
// entries of a table row are a closest-first prefix (ops/neighbors.py), so
// the loop runs over `count[b]` slots; the TPU's sign-sentinel flat table
// (an SMEM layout workaround) is not needed. Per slot the CTA stages the
// [block_src, 16] float32 source tile (4 KB at block_src = 64) in shared
// memory, and every thread walks its sources, reading each source row as
// a broadcast, and accumulates (fx, fy) in registers.
//
// Distance screen. With `screen`, each strip of `strip` sources (the
// whole tile, or `sub` rows) is skipped CTA-wide when no receiver of the
// block lies within the cutoff of any of its sources: every thread takes
// the minimum of its receiver's rho2 over the strip and __syncthreads_or
// votes. The minimum covers inactive and pad rows, as the TPU kernel's
// does, so both skip the same strips.
//
// What bounds it. The twod pair math is ~70 FP32 operations and 6 SFU
// operations (rsqrt x4, sqrt, exp) per pair, and at the main path's
// configuration (100k agents, block_src = 64, kb = 19) each agent sees
// ~875 candidate pairs, i.e. ~8.8e7 pairs per call: FP32 and SFU issue
// bound. The bytes are small (a 4 KB tile per slot, read from L2). The
// legacy field (bicycle2d's default, cutoff ~100 m, kb ~35) sees ~2x the
// pairs at ~35 FP32 and 2 SFU operations each; its rows take a
// warp-uniform branch (one source row per step for the whole warp), so a
// legacy row never pays for the twod chain.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

using csf::kBlock;
using csf::kSrcCols;

template <bool kUniform, bool kFov, bool kP2R, bool kScreen, bool kMixed>
__global__ void __launch_bounds__(kBlock)
pair_forces_twod_kernel(const int* __restrict__ nbr,
                        const int* __restrict__ count,
                        const float* __restrict__ src,
                        const float* __restrict__ recv,
                        float* __restrict__ out, int kb, int block_src,
                        int strip, float cutoff2, csf::TwodParams p) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int npad = gridDim.x * kBlock;
  const int r = b * kBlock + t;
  const csf::Receiver rc = csf::load_receiver(recv, npad, r);

  float fx = 0.0f, fy = 0.0f;
  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);

  for (int k = 0; k < n_slots; ++k) {
    const int sb = nbr[b * kb + k];
    const float4* g =
        reinterpret_cast<const float4*>(src) + (size_t)sb * tile_vec;
    for (int i = t; i < tile_vec; i += kBlock) tile4[i] = g[i];
    __syncthreads();

    for (int j0 = 0; j0 < block_src; j0 += strip) {
      if constexpr (kScreen) {
        float rho2_min = INFINITY;
        for (int j = j0; j < j0 + strip; ++j) {
          rho2_min = fminf(rho2_min, csf::rho2_of(rc, tile + j * kSrcCols));
        }
        if (!__syncthreads_or(rho2_min <= cutoff2)) continue;
      }
      for (int j = j0; j < j0 + strip; ++j) {
        csf::pair_accumulate<kUniform, kFov, kP2R, kMixed>(
            tile + j * kSrcCols, rc, p, fx, fy);
      }
    }
    __syncthreads();
  }
  out[r] = fx;
  out[npad + r] = fy;
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
// column 13 and excludes `uniform`. Returns cudaGetLastError() after the
// launch (0 on success).
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
  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  const size_t smem = sizeof(float) * kSrcCols * block_src;
  auto s = static_cast<cudaStream_t>(stream);
  csf::with_flag(uniform, [&](auto U) {
    csf::with_flag(fov, [&](auto FV) {
      csf::with_flag(p2r, [&](auto P2R) {
        csf::with_flag(screen, [&](auto SCR) {
          csf::with_flag(mixed, [&](auto M) {
            if constexpr (!(decltype(U)::value && decltype(M)::value)) {
              pair_forces_twod_kernel<
                  decltype(U)::value, decltype(FV)::value,
                  decltype(P2R)::value, decltype(SCR)::value,
                  decltype(M)::value><<<n_blocks, kBlock, smem, s>>>(
                  static_cast<const int*>(nbr),
                  static_cast<const int*>(count),
                  static_cast<const float*>(src),
                  static_cast<const float*>(recv), static_cast<float*>(out),
                  kb, block_src, strip, cutoff2, p);
            }
          });
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

const char* csf_error_string(int code) {
  if (code == csf::kErrSharedMemory) {
    return "the launch needs more dynamic shared memory than the device's "
           "opt-in limit per block";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
