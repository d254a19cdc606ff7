// Block-sparse pairwise repulsive-force sum through a ring of source
// tiles, with the tile-level distance screen.
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel_db (one program per receiver block; the neighbor tiles
// stream through a _DB_DEPTH = 4 slot VMEM ring refilled by async DMA; the
// tile screen at the cutoff always on; per-source field parameters always,
// block_src == block), in each of its forms: single-family twod or
// mixed-family (each row's own field, twod or legacy, by its column 13),
// FOV cone on or off, priority to the right on or off. The per-pair math
// is csf::pair_accumulate (pair_math.cuh), shared with pair_forces.cu.
//
// Design. One CTA of 128 threads per receiver block, one receiver per
// thread. A 4-slot ring of [128, 16] float32 tiles (8 KB each, 32 KB in
// all) lives in shared memory. The CTA starts the copies of the first four
// tiles with 16-byte cp.async, one commit group per tile (an empty group
// past count[b], so that group k always holds tile k). At slot k it waits
// until at most three groups are in flight (tile k has landed), screens
// the tile (every thread's minimum rho2 over the tile, __syncthreads_or
// against cutoff2), accumulates it when a pair lies within the cutoff,
// and only after a barrier, when every thread is done with the slot,
// refills it with tile k + 4.
//
// What bounds it. The pair math, FP32 and SFU issue bound as in
// pair_forces.cu; at block_src = 128 the box-to-box table admits ~20% more
// candidate pairs than at 64, and the screen skips only the fringe tiles
// with no pair in range. The copies of the next three tiles overlap the
// current tile's math.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

using csf::kBlock;
using csf::kSrcCols;

constexpr int kDepth = 4;                           // ring slots
constexpr int kTileVec = kBlock * kSrcCols / 4;     // float4 per tile

template <bool kFov, bool kP2R, bool kMixed>
__global__ void __launch_bounds__(kBlock)
pair_forces_db_kernel(const int* __restrict__ nbr,
                      const int* __restrict__ count,
                      const float* __restrict__ src,
                      const float* __restrict__ recv,
                      float* __restrict__ out, int kb, float cutoff2) {
  __shared__ float4 ring4[kDepth * kTileVec];
  const float* ring = reinterpret_cast<const float*>(ring4);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int npad = gridDim.x * kBlock;
  const int r = b * kBlock + t;
  const int n_slots = count[b];

  auto fill = [&](int slot, int k) {
    if (k < n_slots) {
      const float4* g = reinterpret_cast<const float4*>(src) +
                        (size_t)nbr[b * kb + k] * kTileVec;
      float4* dst = ring4 + slot * kTileVec;
      for (int i = t; i < kTileVec; i += kBlock) csf::cp_async16(dst + i, g + i);
    }
    csf::cp_async_commit();
  };

  for (int k = 0; k < kDepth; ++k) fill(k, k);
  const csf::Receiver rc = csf::load_receiver(recv, npad, r);
  const csf::TwodParams unused{};

  float fx = 0.0f, fy = 0.0f;
  for (int k = 0; k < n_slots; ++k) {
    const int slot = k % kDepth;
    const float* tile = ring + slot * kBlock * kSrcCols;
    csf::cp_async_wait<kDepth - 1>();
    __syncthreads();

    float rho2_min = INFINITY;
    for (int j = 0; j < kBlock; ++j) {
      rho2_min = fminf(rho2_min, csf::rho2_of(rc, tile + j * kSrcCols));
    }
    if (__syncthreads_or(rho2_min <= cutoff2)) {
      for (int j = 0; j < kBlock; ++j) {
        csf::pair_accumulate<false, kFov, kP2R, kMixed>(tile + j * kSrcCols,
                                                        rc, unused, fx, fy);
      }
    }
    // refill this slot only after every thread consumed its tile
    __syncthreads();
    fill(slot, k + kDepth);
  }
  out[r] = fx;
  out[npad + r] = fy;
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
            <<<n_blocks, kBlock, 0, s>>>(
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
