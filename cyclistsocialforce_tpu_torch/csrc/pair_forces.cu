// Block-sparse pairwise repulsive-force sum of the BMD2023 "twod" field.
//
// Replaces the Pallas TPU kernel cyclistsocialforce_tpu/ops/pallas_forces.py
// ::_pair_kernel (grid (receiver block, table slot), tile math
// _tile_forces) for the configuration the simulation's main path runs:
// shared field parameters baked in as arguments, the FOV cone on, no
// distance screen, no priority mask, single field family.
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
// What bounds it. The pair math is ~40 FP32 operations and 6 SFU
// operations (rsqrt x4, sqrt, exp) per pair, and at the main path's
// configuration (100k agents, block_src = 64, kb = 19) each agent sees
// ~875 candidate pairs, i.e. ~8.8e7 pairs per call: FP32 and SFU issue
// bound. The bytes are small (a 4 KB tile per slot, read from L2).
//
// Left for later: multi-stage cp.async / TMA staging so the next tile's
// copy overlaps this tile's math, and a wider receiver tile per thread
// (several receivers per thread reuse each shared-memory source read).

#include <cuda_runtime.h>

namespace {

constexpr int kSrcCols = 16;
constexpr int kBlock = 128;

// source pack columns
constexpr int kSX = 0, kSY = 1, kSC = 2, kSS = 3, kF0 = 4;

struct TwodParams {
  float e0, e1, s0, s1, s2, s3, neg_chf;
};

__global__ void __launch_bounds__(kBlock)
pair_forces_twod_kernel(const int* __restrict__ nbr,
                        const int* __restrict__ count,
                        const float* __restrict__ src,
                        const float* __restrict__ recv,
                        float* __restrict__ out, int kb, int block_src,
                        TwodParams p) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int npad = gridDim.x * kBlock;
  const int r = b * kBlock + t;

  const float xr = recv[0 * npad + r];
  const float yr = recv[1 * npad + r];
  const float cr = recv[2 * npad + r];
  const float sr = recv[3 * npad + r];
  const bool act_r = recv[4 * npad + r] > 0.0f;

  const float vd1h_0 = 0.5f * p.s2;
  const float vd1h_1 = 0.5f * p.s3;

  float fx = 0.0f, fy = 0.0f;
  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);

  for (int k = 0; k < n_slots; ++k) {
    const int sb = nbr[b * kb + k];
    const float4* g =
        reinterpret_cast<const float4*>(src) + (size_t)sb * tile_vec;
    for (int i = t; i < tile_vec; i += kBlock) tile4[i] = g[i];
    __syncthreads();

    for (int j = 0; j < block_src; ++j) {
      const float* s = tile + j * kSrcCols;
      const float xs = s[kSX], ys = s[kSY], cs = s[kSC], ss = s[kSS];
      const float f0 = s[kF0];

      const float dx = xr - xs;
      const float dy = yr - ys;
      const float rho2 = dx * dx + dy * dy;
      const float inv_rho = rsqrtf(fmaxf(rho2, 1e-30f));
      const float dxn = dx * inv_rho;
      const float dyn = dy * inv_rho;

      const float sin_rel = ss * cr - cs * sr;
      const float sin2 = sin_rel * sin_rel;
      const float vdecay0 = p.s0 + p.s1 * sin2;
      const float vd1h = vd1h_0 + vd1h_1 * sin2;
      const float e = p.e0 - p.e1 * sin2;

      const float cosphi = dxn * cs + dyn * ss;
      const float sinphi = dyn * cs - dxn * ss;
      // half-angle pieces from one rsqrt of m4 = 4 sin^2(phi/2), taken
      // from the coordinate difference (1 - cos phi cancels); the floor
      // keeps the exactly aligned case bounded, interpolating through
      // the reference's sign(sin phi) jump at phi = 0
      const float ax = dxn - cs;
      const float ay = dyn - ss;
      const float m4 = fmaxf(ax * ax + ay * ay, 4e-12f);
      const float th = vd1h * rsqrtf(m4);
      const float sigma = vdecay0 - m4 * th;
      const float ndsigm = th * sinphi;
      const float ecos = e * cosphi;
      const float ec2 = 1.0f - ecos * ecos;

      // sigma <= 0 folds into P = 0 through the 1e-15 clamp
      const float sig_c = fmaxf(sigma, 1e-15f);
      const float P =
          f0 * expf(-sqrtf(rho2 * ec2) * rsqrtf(sig_c * sig_c));
      const float u = ec2 * sigma;
      const float v = (e * sinphi) * (ecos * sigma) + ec2 * ndsigm;
      const float inv_m = rsqrtf(fmaxf(u * u + v * v, 1e-30f));

      // rho2 > 0 excludes self and coincident pairs; the receiver must
      // see the source inside its half field of view
      const bool tracked =
          (rho2 > 0.0f) && (dxn * cr + dyn * sr <= p.neg_chf) && act_r;
      const float w = tracked ? P * inv_m : 0.0f;
      fx += w * (u * dxn - v * dyn);
      fy += w * (u * dyn + v * dxn);
    }
    __syncthreads();
  }
  out[r] = fx;
  out[npad + r] = fy;
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the first count[b] entries
// of row b are valid source block indices); src [N_src, 16] float32,
// 16-byte aligned, N_src a multiple of block_src; recv [8, n_blocks * 128]
// float32; out [2, n_blocks * 128] float32. Returns cudaGetLastError()
// after the launch (0 on success).
int csf_pair_forces_twod(const void* nbr, const void* count,
                         const void* src, const void* recv, void* out,
                         int n_blocks, int kb, int block_src, float e0,
                         float e1, float s0, float s1, float s2, float s3,
                         float chf, int device, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_src <= 0 || kBlock % block_src != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TwodParams p{e0, e1, s0, s1, s2, s3, -chf};
  const size_t smem = sizeof(float) * kSrcCols * block_src;
  pair_forces_twod_kernel<<<n_blocks, kBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(count),
      static_cast<const float*>(src), static_cast<const float*>(recv),
      static_cast<float*>(out), kb, block_src, p);
  return static_cast<int>(cudaGetLastError());
}

const char* csf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
