// Shared pieces of the block-sparse pair kernels (pair_forces.cu,
// pair_forces_unrolled.cu, pair_forces_db.cu): the source-pack layout, the
// per-pair fields of the Pallas tile math
// cyclistsocialforce_tpu/ops/pallas_forces.py::_tile_forces (the BMD2023
// "twod" field and, in the mixed-family form, the legacy v0.1 elliptic
// field) and the compile-time form switch.
//
// One version of each field lives here, add_pairs, shared by the three
// kernels. It is split in two parts. The decision chain rounds each
// operation as the plain PyTorch version's elementwise op does, with
// intrinsics that no compiler flag contracts, so a kernel decides every
// pair on a discontinuity of the field as the plain version does; the
// smooth rest is fused (see below). The thread-group pieces the kernels
// share (barriers, the screen vote, the sum of the groups' partial sums,
// bulk copies) are in pair_groups.cuh.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace csf {

constexpr int kSrcCols = 16;

// source pack columns
constexpr int kSX = 0, kSY = 1, kSC = 2, kSS = 3, kF0 = 4, kE0 = 5, kE1 = 6,
              kS0 = 7, kS1 = 8, kS2 = 9, kS3 = 10, kCHF = 11, kFAM = 13;
// a legacy row of the mixed form reuses columns 4-7
constexpr int kAmp = kF0, kLegE = kE0, kLegInvSe = kE1, kLegInvPd = kS0;

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

// ---- the per-pair fields ---------------------------------------------------
//
// The BMD2023 "twod" field and the legacy v0.1 elliptic field, each split
// in two parts. The decision chain -- dx, dy, rho2, 1/rho, the unit
// separation (dxn, dyn), the FOV cone and priority-to-the-right
// comparisons, and for the twod field ax, ay, m4 with its floor and sin
// phi -- decides on which side of a discontinuity
// of the field a pair falls: the cone edge, where a whole pair force
// switches on or off, and the sign(sin phi) jump straight ahead of a
// source (the sign of the half-angle term th sin phi). It is written with
// __fadd_rn/__fsub_rn/__fmul_rn, which no flag contracts, in the plain
// version's order (ops/pair_forces.py tile_forces), so a kernel decides
// every pair as the plain version does. The rest is smooth in those quantities:
// explicit fmaf, the MUFU's approximate exponential and reciprocal square
// roots, and one rsqrt for the exponent sqrt(rho2 ec2) / sigma where the
// plain version takes a sqrt and an rsqrt. It differs from the plain
// version by a few float32 ulps of each pair force.

// 1/sqrt(x) on the MUFU. For a normal x this is rsqrtf's result (rsqrtf
// adds only a rescaling of subnormal inputs); a subnormal x flushes to 0
// and gives +inf. Callers that need rsqrtf's value clamp x to a normal
// float first.
__device__ __forceinline__ float rsqrt_mufu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the MUFU; a subnormal result flushes to 0
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLog2eSq = 2.08136898100560770f;   // log2(e)^2

// squared receiver-source distance in the decision chain's rounding, the
// quantity the distance screens compare
__device__ __forceinline__ float rho2_rn(float sx, float sy,
                                         const Receiver& r) {
  const float dx = __fsub_rn(r.x, sx);
  const float dy = __fsub_rn(r.y, sy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The decision chain shared by both fields: rho2, 1/rho, the unit
// separation, and whether the pair is tracked -- not coincident (rho2 >
// 0), inside the receiver's half FOV cone (kFov; neg_chf = -cos(hfov/2)),
// not to its left (kP2R). The receiver's activity applies to its whole
// sum, once, in the kernel.
struct DecisionFrame {
  float rho2, inv_rho, dxn, dyn;
  bool tracked;
};

template <bool kFov, bool kP2R>
__device__ __forceinline__ DecisionFrame decision_frame(float sx, float sy,
                                            const Receiver& r,
                                            float neg_chf) {
  const float dx = __fsub_rn(r.x, sx);
  const float dy = __fsub_rn(r.y, sy);
  const float rho2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float inv_rho = rsqrt_mufu(fmaxf(rho2, 1e-30f));
  const float dxn = __fmul_rn(dx, inv_rho);
  const float dyn = __fmul_rn(dy, inv_rho);
  // every comparison is evaluated and the results combined with `&`, so
  // they stay predicates (no short-circuit branch)
  bool tracked = rho2 > 0.0f;
  if constexpr (kFov) {
    tracked &= __fadd_rn(__fmul_rn(dxn, r.c), __fmul_rn(dyn, r.s)) <= neg_chf;
  }
  if constexpr (kP2R) {
    tracked &= __fsub_rn(__fmul_rn(dyn, r.c), __fmul_rn(dxn, r.s)) >= 0.0f;
  }
  return DecisionFrame{rho2, inv_rho, dxn, dyn, tracked};
}

// a source row as a kernel reads it from shared memory: columns 0-3, 4-7, 8-11
// (16-byte loads) and the family column 13
struct SrcRow {
  float4 a, b, c;
  float fam;
};

template <bool kUniform, bool kMixed>
__device__ __forceinline__ SrcRow load_row(const float4* row) {
  SrcRow s;
  s.a = row[0];
  s.b = row[1];
  s.c = kUniform ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : row[2];
  s.fam = kMixed ? reinterpret_cast<const float*>(row)[kFAM] : 0.0f;
  return s;
}

// the shared field parameters (`uniform`) in the form the pair loop uses
// (e_0 and e_1 times log2(e), see twod_pair)
struct FieldConsts {
  float s0, s1, hs2, hs3, e0, e1, neg_chf;
};

__device__ __forceinline__ FieldConsts field_consts(const TwodParams& p) {
  return FieldConsts{p.s0,          p.s1,          0.5f * p.s2, 0.5f * p.s3,
                   p.e0 * kLog2e, p.e1 * kLog2e, -p.chf};
}

// Add the twod field of row `s` at receiver `r` to (fx, fy).
template <bool kUniform, bool kFov, bool kP2R>
__device__ __forceinline__ void twod_pair(const SrcRow& s, const Receiver& r,
                                        const FieldConsts& p, float& fx,
                                        float& fy) {
  const float cs = s.a.z, ss = s.a.w;
  float s0, s1, hs2, hs3, e0, e1, neg_chf;
  if constexpr (kUniform) {
    s0 = p.s0, s1 = p.s1, hs2 = p.hs2, hs3 = p.hs3;
    e0 = p.e0, e1 = p.e1, neg_chf = p.neg_chf;
  } else {
    s0 = s.b.w, s1 = s.c.x, hs2 = s.c.y * 0.5f, hs3 = s.c.z * 0.5f;
    e0 = s.b.y * kLog2e, e1 = s.b.z * kLog2e, neg_chf = -s.c.w;
  }
  // decision chain
  const DecisionFrame f = decision_frame<kFov, kP2R>(s.a.x, s.a.y, r, neg_chf);
  const float sinphi = __fsub_rn(__fmul_rn(f.dyn, cs), __fmul_rn(f.dxn, ss));
  const float ax = __fsub_rn(f.dxn, cs);
  const float ay = __fsub_rn(f.dyn, ss);
  const float m4 =
      fmaxf(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)), 4e-12f);

  // smooth rest
  const float cosphi = fmaf(f.dxn, cs, f.dyn * ss);
  const float sin_rel = fmaf(ss, r.c, -(cs * r.s));
  const float sin2 = sin_rel * sin_rel;
  const float vdecay0 = fmaf(s1, sin2, s0);
  const float vd1h = fmaf(hs3, sin2, hs2);
  const float th = vd1h * rsqrt_mufu(m4);
  const float sigma = fmaf(-m4, th, vdecay0);
  // e, ecos and ec2 carry factors log2(e), log2(e) and log2(e)^2, and so
  // u and v both carry log2(e)^2: the force direction (u, v) / |(u, v)|
  // is unchanged, and the exponent comes out in base 2
  const float e = fmaf(-e1, sin2, e0);
  const float ecos = e * cosphi;
  const float ec2 = fmaf(-ecos, ecos, kLog2eSq);
  // the exponent sqrt(q) / sig_c, q = rho2 ec2, from one rsqrt as
  // q rsqrt(q sig_c^2). Where q sig_c^2 is below the least normal float
  // (with sigma <= 0, clamped to 1e-15, every pair closer than ~1e-4 m)
  // the MUFU reads it as 0 and the exponent is +inf, so P = 0; the plain
  // version's float32 P there is 0 too unless the pair is closer than
  // ~3e-8 m (~1e-12 m with sigma <= 0). q = 0 (0 * inf) gives NaN, which
  // the fmaxf takes to 0, as the plain version's sqrt(0) does.
  const float sig_c = fmaxf(sigma, 1e-15f);
  const float q = f.rho2 * ec2;
  const float expo = fmaxf(q * rsqrt_mufu(q * (sig_c * sig_c)), 0.0f);
  const float P = s.b.x * exp2_mufu(-expo);
  const float u = ec2 * sigma;
  const float v = fmaf(ec2, th * sinphi, (e * sinphi) * (ecos * sigma));
  const float inv_m = rsqrt_mufu(fmaxf(fmaf(u, u, v * v), 1e-30f));
  const float w = f.tracked ? P * inv_m : 0.0f;
  const float wu = w * u, wv = w * v;
  fx = fmaf(wu, f.dxn, fmaf(-wv, f.dyn, fx));
  fy = fmaf(wu, f.dyn, fmaf(wv, f.dxn, fy));
}

// Add the legacy field of row `s` (a legacy row of the mixed form) at
// receiver `r` to (fx, fy).
template <bool kFov, bool kP2R>
__device__ __forceinline__ void legacy_pair(const SrcRow& s, const Receiver& r,
                                          float& fx, float& fy) {
  const float cs = s.a.z, ss = s.a.w;
  const float amp = s.b.x, e = s.b.y, inv_se = s.b.z, inv_pd = s.b.w;
  const DecisionFrame f = decision_frame<kFov, kP2R>(s.a.x, s.a.y, r, -s.c.w);
  const float cosphi = fmaf(f.dxn, cs, f.dyn * ss);
  const float sinphi = fmaf(f.dyn, cs, -(f.dxn * ss));
  const float u = fmaf(-e, cosphi, 1.0f) * inv_se;
  const float P =
      amp * exp2_mufu(-((f.rho2 * f.inv_rho) * u) * (inv_pd * kLog2e));
  const float pw = f.tracked ? P : 0.0f;
  const float frho0 = pw * u;
  const float fphi0 = ((pw * e) * sinphi) * inv_se;
  fx = fmaf(frho0, f.dxn, fmaf(-fphi0, f.dyn, fx));
  fy = fmaf(frho0, f.dyn, fmaf(fphi0, f.dxn, fy));
}

// Add row `s`'s field at each of a thread's R receivers to its sums, in
// its form:
//   kUniform: the 7 twod field parameters come from `p`, else from the row;
//   kFov:     the receiver must see the source inside its half FOV cone;
//   kP2R:     priority to the right, (dyn cr - dxn sr) >= 0;
//   kMixed:   the row's family column selects the legacy field (1) or the
//             twod field from the row's columns (0); excludes kUniform.
// In the kernels every thread of a warp reads the same source row, so the
// family branch is warp-uniform: a row evaluates its own field only (the
// Pallas tile evaluates both on its vector lanes and selects).
template <bool kUniform, bool kFov, bool kP2R, bool kMixed, int R>
__device__ __forceinline__ void add_pairs(const SrcRow& s,
                                         const Receiver (&r)[R],
                                         const FieldConsts& p, float (&fx)[R],
                                         float (&fy)[R]) {
  static_assert(!(kUniform && kMixed), "the mixed form reads the columns");
  if constexpr (kMixed) {
    if (s.fam > 0.5f) {
#pragma unroll
      for (int i = 0; i < R; ++i) legacy_pair<kFov, kP2R>(s, r[i], fx[i], fy[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    twod_pair<kUniform, kFov, kP2R>(s, r[i], p, fx[i], fy[i]);
  }
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

// Call f(std::integral_constant<int, block>{}) for a receiver block the
// kernels are compiled for (64, 128, 256) and return true; false for any
// other block, which the launchers refuse.
template <typename F>
inline bool with_block(int block, F&& f) {
  switch (block) {
    case 64:
      f(std::integral_constant<int, 64>{});
      return true;
    case 128:
      f(std::integral_constant<int, 128>{});
      return true;
    case 256:
      f(std::integral_constant<int, 256>{});
      return true;
    default:
      return false;
  }
}

}  // namespace csf
