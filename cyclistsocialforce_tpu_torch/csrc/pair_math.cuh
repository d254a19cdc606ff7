// Shared pieces of the block-sparse pair kernels (pair_forces.cu,
// pair_forces_unrolled.cu, pair_forces_db.cu): the source-pack layout, the
// per-pair fields of the Pallas tile math
// cyclistsocialforce_tpu/ops/pallas_forces.py::_tile_forces (the BMD2023
// "twod" field and, in the mixed-family form, the legacy v0.1 elliptic
// field), the compile-time form switch, and the cp.async primitives.
//
// Every kernel is compiled with -fmad=false (ops/_build.py), so each
// operation here rounds as the plain PyTorch version's elementwise op does
// and the two agree pair by pair, also at the field's discontinuities.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace csf {

constexpr int kSrcCols = 16;
constexpr int kBlock = 128;        // receivers per block, one per thread

// source pack columns
constexpr int kSX = 0, kSY = 1, kSC = 2, kSS = 3, kF0 = 4, kE0 = 5, kE1 = 6,
              kS0 = 7, kS1 = 8, kS2 = 9, kS3 = 10, kCHF = 11, kFAM = 13;
// a legacy row of the mixed form reuses columns 4-7
constexpr int kAmp = kF0, kLegE = kE0, kLegInvSe = kE1, kLegInvPd = kS0;

// returned by a launcher when the dynamic shared memory a launch needs
// exceeds the device's opt-in limit (see csf_error_string)
constexpr int kErrSharedMemory = 100000;

// shared field parameters (the `uniform` form); unused otherwise
struct TwodParams {
  float e0, e1, s0, s1, s2, s3, chf;
};

struct Receiver {
  float x, y, c, s;
  bool act;
};

__device__ __forceinline__ Receiver load_receiver(const float* recv,
                                                  int npad, int r) {
  return Receiver{recv[0 * npad + r], recv[1 * npad + r],
                  recv[2 * npad + r], recv[3 * npad + r],
                  recv[4 * npad + r] > 0.0f};
}

// squared receiver-source distance in the kernel's operation order
// (receiver minus source), the quantity the distance screens compare
__device__ __forceinline__ float rho2_of(const Receiver& r, const float* s) {
  const float dx = r.x - s[kSX];
  const float dy = r.y - s[kSY];
  return dx * dx + dy * dy;
}

// The pair's geometry in the kernel's operation order: rho^2, 1/rho and
// the unit separation (dxn, dyn), receiver minus source, and cos/sin of
// its angle phi in the source's heading frame.
struct PairFrame {
  float rho2, inv_rho, dxn, dyn, cosphi, sinphi;
};

__device__ __forceinline__ PairFrame pair_frame(const float* s,
                                                const Receiver& r) {
  const float cs = s[kSC], ss = s[kSS];
  const float dx = r.x - s[kSX];
  const float dy = r.y - s[kSY];
  const float rho2 = dx * dx + dy * dy;
  const float inv_rho = rsqrtf(fmaxf(rho2, 1e-30f));
  const float dxn = dx * inv_rho;
  const float dyn = dy * inv_rho;
  return PairFrame{rho2, inv_rho, dxn, dyn, dxn * cs + dyn * ss,
                   dyn * cs - dxn * ss};
}

// Is the pair tracked: not the self or a coincident pair (rho2 > 0), the
// receiver active, inside the receiver's half FOV cone of the source's
// hfov (kFov; neg_chf = -cos(hfov/2)), not to its left (kP2R)?
template <bool kFov, bool kP2R>
__device__ __forceinline__ bool pair_tracked(float rho2, float dxn,
                                             float dyn, const Receiver& r,
                                             float neg_chf) {
  bool tracked = (rho2 > 0.0f) && r.act;
  if constexpr (kFov) {
    tracked = tracked && (dxn * r.c + dyn * r.s <= neg_chf);
  }
  if constexpr (kP2R) {
    tracked = tracked && (dyn * r.c - dxn * r.s >= 0.0f);
  }
  return tracked;
}

// Add the legacy field of source row `s` (a legacy row of the mixed form)
// at receiver `r` to (fx, fy), in the Pallas tile's operation order.
template <bool kFov, bool kP2R>
__device__ __forceinline__ void legacy_accumulate(const float* s,
                                                  const Receiver& r,
                                                  float& fx, float& fy) {
  const PairFrame f = pair_frame(s, r);
  const float rho = f.rho2 * f.inv_rho;
  const float e = s[kLegE], inv_se = s[kLegInvSe];
  const float u = (1.0f - e * f.cosphi) * inv_se;
  const float P = s[kAmp] * expf(((-rho) * u) * s[kLegInvPd]);
  const float frho0 = P * u;
  const float fphi0 = ((P * e) * f.sinphi) * inv_se;
  if (pair_tracked<kFov, kP2R>(f.rho2, f.dxn, f.dyn, r, -s[kCHF])) {
    fx += frho0 * f.dxn - fphi0 * f.dyn;
    fy += frho0 * f.dyn + fphi0 * f.dxn;
  }
}

// Add source row `s`'s field at receiver `r` to (fx, fy).
//   kUniform: the 7 twod field parameters come from `p`, else from the row;
//   kFov:     the receiver must see the source inside its half FOV cone;
//   kP2R:     priority to the right, (dyn cr - dxn sr) >= 0;
//   kMixed:   the row's family column selects the legacy field (1) or the
//             twod field from the row's columns (0); excludes kUniform.
// In the kernels every thread of a warp reads the same source row, so the
// family branch is warp-uniform: a row evaluates its own field only (the
// Pallas tile evaluates both on its vector lanes and selects).
template <bool kUniform, bool kFov, bool kP2R, bool kMixed = false>
__device__ __forceinline__ void pair_accumulate(const float* s,
                                                const Receiver& r,
                                                const TwodParams& p,
                                                float& fx, float& fy) {
  static_assert(!(kUniform && kMixed), "the mixed form reads the columns");
  if constexpr (kMixed) {
    if (s[kFAM] > 0.5f) {
      legacy_accumulate<kFov, kP2R>(s, r, fx, fy);
      return;
    }
  }
  const float cs = s[kSC], ss = s[kSS];
  const PairFrame f = pair_frame(s, r);
  const float rho2 = f.rho2, dxn = f.dxn, dyn = f.dyn;
  const float cosphi = f.cosphi, sinphi = f.sinphi;

  const float sin_rel = ss * r.c - cs * r.s;
  const float sin2 = sin_rel * sin_rel;
  float vdecay0, vd1h, e;
  if constexpr (kUniform) {
    vdecay0 = p.s0 + p.s1 * sin2;
    vd1h = 0.5f * p.s2 + (0.5f * p.s3) * sin2;
    e = p.e0 - p.e1 * sin2;
  } else {
    vdecay0 = s[kS0] + s[kS1] * sin2;
    vd1h = s[kS2] * 0.5f + (s[kS3] * 0.5f) * sin2;
    e = s[kE0] - s[kE1] * sin2;
  }

  // half-angle pieces from one rsqrt of m4 = 4 sin^2(phi/2), taken from
  // the coordinate difference (1 - cos phi cancels); the floor keeps the
  // exactly aligned case bounded, interpolating through the reference's
  // sign(sin phi) jump at phi = 0
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
  const float P = s[kF0] * expf(-sqrtf(rho2 * ec2) * rsqrtf(sig_c * sig_c));
  const float u = ec2 * sigma;
  const float v = (e * sinphi) * (ecos * sigma) + ec2 * ndsigm;
  const float inv_m = rsqrtf(fmaxf(u * u + v * v, 1e-30f));

  const float neg_chf = kUniform ? -p.chf : -s[kCHF];
  const float w =
      pair_tracked<kFov, kP2R>(rho2, dxn, dyn, r, neg_chf) ? P * inv_m : 0.0f;
  fx += w * (u * dxn - v * dyn);
  fy += w * (u * dyn + v * dxn);
}

// Call f(std::integral_constant<bool, v>{}): turns a runtime flag into a
// template argument, so a launcher picks one of the compiled forms.
// (The mixed form with uniform constants is not a form: the launchers
// refuse it before they reach a kernel.)
template <typename F>
inline void with_flag(bool v, F&& f) {
  if (v) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
}

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

}  // namespace csf
