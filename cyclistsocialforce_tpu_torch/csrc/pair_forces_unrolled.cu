// Block-sparse pairwise repulsive-force sum, every source tile of a
// receiver block staged up front.
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel_unrolled (one program per receiver block; all KB source
// tile DMAs issued first into a KB-deep VMEM scratch, then a statically
// unrolled accumulate with no distance screen), in each of its forms:
// `uniform` or per-source field parameters, the mixed-family form (each
// row's own field, twod or legacy, by its column 13), FOV cone on or off,
// priority to the right on or off. The per-pair math is
// csf::pair_accumulate (pair_math.cuh), shared with pair_forces.cu.
//
// Design. One CTA of 128 threads per receiver block, one receiver per
// thread. The CTA issues 16-byte cp.async copies of all count[b] valid
// source tiles into dynamic shared memory, waits for them once, and then
// every thread walks all count[b] * block_src sources with no barrier
// between slots. Shared memory is kb * block_src * 64 B (77,824 B at kb 19,
// block_src 64), above the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit first and refuses a launch that
// exceeds the device's opt-in limit.
//
// What bounds it. The same ~8.8e7 pair evaluations per call as
// pair_forces.cu at the main path's shape, FP32 and SFU issue bound. The
// large shared-memory footprint allows only two CTAs (8 warps) per SM, so
// fewer warps hide the latency of each thread's dependent FP32/SFU chain
// than in pair_forces.cu; what it saves is one barrier per slot. The
// legacy field's table (kb ~35 at cutoff 100 m) takes 143,360 B: one CTA
// per SM.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

using csf::kBlock;
using csf::kSrcCols;

template <bool kUniform, bool kFov, bool kP2R, bool kMixed>
__global__ void __launch_bounds__(kBlock)
pair_forces_unrolled_kernel(const int* __restrict__ nbr,
                            const int* __restrict__ count,
                            const float* __restrict__ src,
                            const float* __restrict__ recv,
                            float* __restrict__ out, int kb, int block_src,
                            csf::TwodParams p) {
  extern __shared__ float4 tiles4[];
  const float* tiles = reinterpret_cast<const float*>(tiles4);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int npad = gridDim.x * kBlock;
  const int r = b * kBlock + t;

  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);
  for (int k = 0; k < n_slots; ++k) {
    const float4* g = reinterpret_cast<const float4*>(src) +
                      (size_t)nbr[b * kb + k] * tile_vec;
    float4* dst = tiles4 + k * tile_vec;
    for (int i = t; i < tile_vec; i += kBlock) csf::cp_async16(dst + i, g + i);
  }
  csf::cp_async_commit();
  const csf::Receiver rc = csf::load_receiver(recv, npad, r);
  csf::cp_async_wait<0>();
  __syncthreads();

  float fx = 0.0f, fy = 0.0f;
  const int n_src = n_slots * block_src;
  for (int j = 0; j < n_src; ++j) {
    csf::pair_accumulate<kUniform, kFov, kP2R, kMixed>(tiles + j * kSrcCols,
                                                       rc, p, fx, fy);
  }
  out[r] = fx;
  out[npad + r] = fy;
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`; arguments as for
// csf_pair_forces_twod (pair_forces.cu), without the screen. Returns
// csf::kErrSharedMemory when kb * block_src source rows exceed the
// device's opt-in shared memory per block, else cudaGetLastError() after
// the launch (0 on success).
int csf_pair_forces_unrolled(const void* nbr, const void* count,
                             const void* src, const void* recv, void* out,
                             int n_blocks, int kb, int block_src,
                             int uniform, int mixed, int fov, int p2r,
                             float e0,
                             float e1, float s0, float s1, float s2,
                             float s3, float chf, int device, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_src <= 0 || kBlock % block_src != 0 || kb <= 0 ||
      (uniform && mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * kSrcCols * block_src * (size_t)kb;
  if (smem > static_cast<size_t>(optin)) return csf::kErrSharedMemory;

  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  auto s = static_cast<cudaStream_t>(stream);
  csf::with_flag(uniform, [&](auto U) {
    csf::with_flag(fov, [&](auto FV) {
      csf::with_flag(p2r, [&](auto P2R) {
        csf::with_flag(mixed, [&](auto M) {
          if constexpr (!(decltype(U)::value && decltype(M)::value)) {
            auto kernel = pair_forces_unrolled_kernel<
                decltype(U)::value, decltype(FV)::value,
                decltype(P2R)::value, decltype(M)::value>;
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return;
            kernel<<<n_blocks, kBlock, smem, s>>>(
                static_cast<const int*>(nbr), static_cast<const int*>(count),
                static_cast<const float*>(src),
                static_cast<const float*>(recv), static_cast<float*>(out), kb,
                block_src, p);
            err = cudaGetLastError();
          }
        });
      });
    });
  });
  return static_cast<int>(err);
}

}  // extern "C"
