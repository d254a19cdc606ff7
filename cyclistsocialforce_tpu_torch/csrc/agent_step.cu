// One step of a bicycle2d, twod or balancing-rider engine's per-agent
// chain, in two kernels around the pair kernel (K1, K2 or K3):
//
//   agent_pre   the destination queue update, the navigation FSM and the
//               destination force, then the pair packs (src [npad, 16],
//               recv [8, npad]) of the twod or the legacy field; an
//               inactive row's FSM fields held at their pre-step values.
//               A template over the destination force: the straight line
//               (bicycle2d, the balancing rider) or the spline of the
//               twod model (its design and bound in the note above
//               `spline_force`);
//   agent_post  the repulsion clamped to the destination force's magnitude
//               and added to it, bicycle2d's P control and kinematics, and
//               the bookkeeping of the step (inactive rows held, step
//               counters, the position ring); a template over the twod
//               model's arrived-freeze, whose instance copies the ring a
//               warp at a time;
//   agent_post_kernel_whipple
//               the balancing rider's counterpart of agent_post: the same
//               clamp, then the linearised Whipple-Carvallo step with its
//               gains from a piecewise polynomial over speed, then the same
//               bookkeeping. It shares no logic with agent_post (the two
//               models differ in the state they keep and in the work: a
//               5x5 solve against a kinematic update), only the
//               __forceinline__ helpers below. Its design and its bound
//               are in the note above the kernel.
//
// Replaces the per-agent part of the program that XLA compiles for one
// step of the JAX package's chunk (cyclistsocialforce_tpu/engine.py
// nav_params_view :49-66, dest_force_straight :73-102 and
// dest_force_spline, pack_pair_fields :901-980, calc_forces' clamp
// :1118-1151, models/bicycle2d.py and models/bicycle_twod.py step,
// finish_step :1153-1198), which it fuses there; the port ran it as ~330
// PyTorch kernels of ~2 us each (the twod model's as ~800).
//
// What bounds it. One thread per agent row, each reading and writing only
// its own row: ~240 bytes an agent in agent_pre (the state it reads, the
// FSM fields and the 96 bytes of packs it writes) and ~265 in agent_post
// (the position ring of H = 8 copied, 120 bytes, since the step is out of
// place), against ~300 FP32 operations an agent in all. Memory bandwidth
// bounds both: 7 and 8 us at 100,000 riders on an H100's 3.35 TB/s.
//
// Exactness. The chain has discontinuities (the FSM's thresholds, the
// `ddest < 3` slow-down, the angle wraps, the emit flags), where a one-ulp
// difference flips a branch and two runs part. So every operation rounds
// as the plain PyTorch version's CUDA kernel does, one operation at a
// time: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn/__fsqrt_rn, which nothing
// contracts, in the plain version's order; the CUDA math library's sinf,
// cosf, tanf, atan2f and powf, which PyTorch's kernels call; a division by
// a shared (Python float) parameter as PyTorch's CUDA kernel computes it,
// a multiplication by the float reciprocal that the host computed; a
// Python float in a tensor operation cast to float first, and an
// expression of Python floats alone evaluated in double on the host
// (ops/agent_step.py passes those constants).

#include <cuda_runtime.h>

#include <type_traits>

namespace csf {

// One pair-field column: a per-rider table read by uid (clamped to its
// last row, as the plain version's gather), or one shared value.
struct PairCol {
  const void* p;      // nullptr: shared, `v`
  long long rows;     // rows of the table
  int f64;            // the table is float64 (cast to float32 on load)
  float v;
};

enum Col { kHfov, kP0, kPdecay, kF0, kE0, kE1, kS0, kS1, kS2, kS3, kVmax,
           kNumCols };

struct AgentPreArgs {
  const float* s;               // [n, 8]
  const float* dest;            // [n, 3]
  const float* destqueue;       // [n, q, 3]
  const int* destpointer;       // [n]
  const int* nq;                // [n]
  const unsigned char* znav;    // [n, 3] bool
  const float* znavparams;      // [n, 4]
  const int* i_step;            // [n]
  const int* i_stopsignal;      // [n]
  const float* d_stopsignal;    // [n]
  const unsigned char* active;  // [n] bool
  const int* uid;               // [n]
  float* fdx;                   // [n]
  float* fdy;                   // [n]
  float* dest_out;              // [n, 3]
  int* ptr_out;                 // [n]
  unsigned char* znav_out;      // [n, 3]
  float* znavp_out;             // [n, 4]
  int* istop_out;               // [n]
  float* dstop_out;             // [n]
  float* src_pack;              // [npad, 16]
  float* recv_pack;             // [8, npad]
  int n, npad, q, legacy;
  // navigation: Python floats cast to float32, and the host's constants
  float d_arrived_inter, d_arrived_stop, v_max_stop, v_max_harddecel;
  float v_desired_default;
  float vh2;          // float(vh * vh), the product in double
  float inv_a_des;    // 1.0f / float(a_desired_default[0])
  float d1_new;       // float(0.5 * -(vh * vh) / a_max[0]), in double
  float inv_k;        // 1.0f / 1.5f
  PairCol cols[kNumCols];
};

struct AgentPostArgs {
  const float* s;               // [n, 8], the pre-step state ...
  const float* pid_e;           // [n, 2]
  const float* pid_i;           // [n, 2]
  const int* i_step;            // [n]
  const int* t_glob;            // [1]
  const float* pos_hist;        // [n, hist, 2]
  const unsigned char* active;  // [n]
  const int* nq;                // [n]
  const float* dest;            // [n, 3], agent_pre's destination ...
  const int* destpointer;       // [n], ... and queue pointer ...
  const float* fdx;             // ... its destination force ...
  const float* fdy;
  const float* frx;             // ... and the pair stage's sums, [n] each
  const float* fry;
  float* s_out;
  float* pid_e_out;
  float* pid_i_out;
  int* i_out;
  int* t_out;
  float* pos_hist_out;
  float* fx;                    // the applied force, every row
  float* fy;
  int n, hist;
  // bicycle2d: Python floats cast to float32, and the host's reciprocals
  float t_s, inv_t_s, k_p_delta, k_p_v, a_max_lo, a_max_hi, delta_max;
  float neg_delta_max, v_max_lo, v_max_hi, inv_l;
};

struct AgentPostWhippleArgs {
  const float* s;               // [n, 8], the pre-step state ...
  const float* dyn_x;           // [n, 7] the bike frame's latents
  const float* dyn_v;           // [n]
  const float* dyn_gains;       // [n, gains], K in columns 0-4
  const int* i_step;            // [n]
  const int* t_glob;            // [1]
  const float* pos_hist;        // [n, hist, 2]
  const unsigned char* active;  // [n]
  const float* fdx;             // agent_pre's destination force ...
  const float* fdy;
  const float* frx;             // ... and the pair stage's sums, [n] each
  const float* fry;
  const float* a0;              // [5, 5]: A(v) = a0 + v a1 + v^2 a2
  const float* a1;
  const float* a2;
  const float* b;               // [5], the steer-torque input
  const float* coeffs;          // [5 * deg1, segs], the gains' fit, with
                                // strides coeff_row and coeff_seg
  float* s_out;
  float* dyn_x_out;
  float* dyn_v_out;
  float* dyn_gains_out;
  int* i_out;
  int* t_out;
  float* pos_hist_out;
  float* fx;                    // the applied force, every row
  float* fy;
  int n, hist, gains, deg1, segs, coeff_row, coeff_seg;
  // Python floats cast to float32: t_s and float(t_s / 2.0) (in double),
  // k_p_v and the limits; the fit's lower edge, the float32 reciprocal of
  // its segment width and float(segs - 1e-6), its clamp
  float t_s, half_t_s, k_p_v, a_max_lo, a_max_hi, v_max_lo, v_max_hi;
  float poly_lo, inv_seg_dv, x_max;
};

// agent_pre's spline instance: agent_pre's arguments, then the position
// ring the spline looks back into
struct AgentPreSplineArgs : AgentPreArgs {
  const float* pos_hist;               // [n, hist, 2]
  const int* t_glob;                   // [1]
  int hist, lookback;                  // lookback: floor(1 / t_s) steps
  // the host's float32 reciprocals 1.0f / 6.0f and 1.0f / 3.0f, the
  // nearest-sample grid's step float(1.0 / 19), float(theta_comf) *
  // float(g) rounded in float, and the lowest curve speed 2.5
  float sixth, third, q_step, tc_g, v_stable;
};

// agent_post's twod instance: agent_post's arguments and agent_pre's FSM
// state, whose "arrived" flag freezes the row
struct AgentPostTwodArgs : AgentPostArgs {
  const unsigned char* znav;           // [n, 3] bool
};

}  // namespace csf

namespace {

using namespace csf;

constexpr int kThreads = 256;
constexpr int kSrcCols = 16;
constexpr int kRecvRows = 8;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float col(const PairCol& c, int uid) {
  if (c.p == nullptr) return c.v;
  long long r = uid < c.rows - 1 ? uid : c.rows - 1;
  if (r < 0) r += c.rows;   // a negative index counts from the end
  return c.f64 ? static_cast<float>(static_cast<const double*>(c.p)[r])
               : static_cast<const float*>(c.p)[r];
}

__device__ __forceinline__ float norm_rn(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// PyTorch's clamp_max / clamp_min: NaN passes through
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// utils/angles.py thresh: clamp(clamp(x, max=hi), min=lo)
__device__ __forceinline__ float thresh(float x, float lo, float hi) {
  return clamp_min(clamp_max(x, hi), lo);
}

// utils/angles.py limit_angle; theta / 2pi as PyTorch's CUDA kernel
// divides by a Python float, by the float reciprocal
__device__ __forceinline__ float limit_angle(float theta, float inv_two_pi) {
  theta = __fsub_rn(theta,
                    __fmul_rn(floorf(__fmul_rn(theta, inv_two_pi)), kTwoPi));
  theta = theta > kPi ? __fsub_rn(theta, kTwoPi) : theta;
  theta = theta < -kPi ? __fadd_rn(theta, kTwoPi) : theta;
  return theta;
}

// utils/angles.py angle_difference
__device__ __forceinline__ float angle_difference(float a1, float a2,
                                                  float inv_two_pi) {
  float da = fabsf(__fsub_rn(a1, a2));
  da = da > kPi ? __fsub_rn(kTwoPi, da) : da;
  const float t1 =
      fabsf(__fsub_rn(limit_angle(__fsub_rn(a1, da), inv_two_pi), a2));
  const float t2 =
      fabsf(__fsub_rn(limit_angle(__fadd_rn(a1, da), inv_two_pi), a2));
  return t1 < t2 ? -da : da;
}

// ops/control.py pid_step with zero integral and derivative gains (the
// zeros multiplied in as the plain version does: signed zeros and NaNs
// follow it); returns the output, *i_new the integral
__device__ __forceinline__ float pid_p(float e, float e_prev, float i_prev,
                                       float kp, float t_s, float inv_t_s,
                                       float* i_new) {
  const float d = __fmul_rn(__fmul_rn(0.0f, __fsub_rn(e_prev, e)), inv_t_s);
  *i_new = __fadd_rn(i_prev, __fmul_rn(__fmul_rn(0.0f, e), t_s));
  return __fadd_rn(__fadd_rn(__fmul_rn(kp, e), *i_new), d);
}

// ops/forces.py clamp_add_dest (utils/angles.py limit_magnitude): the
// repulsion (frx, fry) clamped to the destination force's magnitude and
// added to it (agent_post writes the same operations out inline)
__device__ __forceinline__ void clamp_add_dest(float fdx, float fdy,
                                               float frx, float fry,
                                               float* fx, float* fy) {
  const float r = norm_rn(fdx, fdy);
  const float rin = norm_rn(frx, fry);
  const float scale =
      rin > r ? __fdiv_rn(r, rin > 0.0f ? rin : 1.0f) : 1.0f;
  *fx = __fadd_rn(__fmul_rn(frx, scale), fdx);
  *fy = __fadd_rn(__fmul_rn(fry, scale), fdy);
}

// A row's pack columns 4-10 (the field's parameters, amplitude first) and
// 12 (emit) from the row's speed v, activity act and uid
__device__ __forceinline__ void field_cols(const AgentPreArgs& a, float v,
                                           float act, int uid, float* c) {
  if (a.legacy) {
    // ops/forces.py legacy_excentricity: min((max(v, 0) / v_max)^0.1, 0.7)
    const float vm = col(a.cols[kVmax], uid);
    const float e = clamp_max(
        powf(__fdiv_rn(clamp_min(v, 0.0f), vm), 0.1f), 0.7f);
    const float pd = col(a.cols[kPdecay], uid);
    const float amp = __fdiv_rn(col(a.cols[kP0], uid), pd);
    const float emit = __fmul_rn(act, amp > 0.0f ? 1.0f : 0.0f);
    c[4] = __fmul_rn(amp, emit);
    c[5] = e;
    c[6] = __fdiv_rn(1.0f, __fsqrt_rn(__fsub_rn(1.0f, __fmul_rn(e, e))));
    c[7] = __fdiv_rn(1.0f, pd);
    c[8] = c[9] = c[10] = 0.0f;
    c[12] = emit;
  } else {
    const float f0 = col(a.cols[kF0], uid);
    const float emit = __fmul_rn(act, f0 > 0.0f ? 1.0f : 0.0f);
    c[4] = __fmul_rn(f0, emit);
    c[5] = col(a.cols[kE0], uid);
    c[6] = col(a.cols[kE1], uid);
    c[7] = col(a.cols[kS0], uid);
    c[8] = col(a.cols[kS1], uid);
    c[9] = col(a.cols[kS2], uid);
    c[10] = col(a.cols[kS3], uid);
    c[12] = emit;
  }
}

// A row's navigation after one pass of the destination-queue update and
// the FSM: its destination, pointer, stop log, FSM state and parameters,
// the distance to the new destination and the desired speed
struct NavPass {
  float ndx, ndy, ndz, dstop, ddest, vd, zn0, zn1, zn2, zn3;
  int ptr, istop;
  bool n0, n1, n2;
};

// ops/navigation.py update_destination, dest_distance at the new pointer
// and update_nav_state, from the row's fields before the pass: its
// destination d0, pointer p0 and FSM state z, and behind zp, istop_in and
// dstop_in the FSM's parameters, stop step and stop distance
__device__ __forceinline__ NavPass nav_pass(
    const AgentPreArgs& a, const float* dq, float x, float y, float v,
    int nq, int i_step, int p0, bool z0, bool z1, bool z2, float d0x,
    float d0y, float d0z, const float* zp, const int* istop_in,
    const float* dstop_in) {
  auto entry = [&](int p) {
    p = p < 0 ? 0 : (p > a.q - 1 ? a.q - 1 : p);
    return dq + 3 * p;
  };
  auto dist = [&](int p) {
    const float* e = entry(p);
    return norm_rn(__fsub_rn(e[0], x), __fsub_rn(e[1], y));
  };
  NavPass o;

  // ops/navigation.py update_destination
  const float dnext = dist(p0);
  const bool skip = z1 || z2;
  int ptr = dnext <= a.d_arrived_inter ? min(p0 + 1, nq - 1) : p0;
  const bool has_next = ptr < nq - 1;
  const int nxt = min(max(ptr + 1, 0), a.q - 1);
  if (has_next && dist(nxt) < dnext) ptr = ptr + 1;
  if (skip) ptr = p0;
  float ndx = d0x, ndy = d0y, ndz = d0z;
  if (!skip) {
    const float* e = entry(ptr);
    ndx = e[0];
    ndy = e[1];
    ndz = e[2];
  }
  const bool became_stop = !skip && d0z <= 0.0f && ndz > 0.0f;
  o.istop = became_stop ? i_step : *istop_in;
  o.dstop = became_stop
                ? norm_rn(__fsub_rn(d0x, ndx), __fsub_rn(d0y, ndy))
                : *dstop_in;
  // ops/navigation.py dest_distance at the new pointer
  const float ddest = dist(ptr);

  // ops/navigation.py update_nav_state
  const float d0_new = __fmul_rn(
      __fmul_rn(0.5f, __fsub_rn(a.vh2, __fmul_rn(v, v))), a.inv_a_des);
  const float d0 = z0 ? d0_new : zp[1];
  const float d1 = z0 ? a.d1_new : zp[2];
  const bool x0 = ndz > 0.0f;
  const bool x1 = ddest <= __fmul_rn(1.5f, __fadd_rn(d0, d1));
  const bool x2 = ddest <= a.d_arrived_stop;
  const bool x3 = v <= a.v_max_stop;
  const bool n0 = !x0 || (x0 && !x1 && ((z0 && !x2) || z1));
  const bool n1 = x0 && ((z0 && ((!x2 && x1) || (x2 && !x3))) ||
                         (z1 && x1 && (!x2 || !x3)));
  const bool n2 = x0 && (((z0 || z1) && x2 && x3) || z2);
  const bool latch = z0 && n1;
  const float zn0 = latch ? v : zp[0];
  const float zn1 = latch ? d0 : zp[1];
  const float zn2 = latch ? d1 : zp[2];
  const float zn3 = latch ? static_cast<float>(i_step) : zp[3];
  const float d0_safe = zn1 != 0.0f ? zn1 : 1.0f;
  const float d1_safe = zn2 != 0.0f ? zn2 : 1.0f;
  const float vh = a.v_max_harddecel;
  // vh / d1_safe: a Python float over a tensor is the tensor's reciprocal
  // times the float
  const float near = __fmul_rn(
      __fmul_rn(__fmul_rn(__fdiv_rn(1.0f, d1_safe), vh), ddest), a.inv_k);
  const float far = __fadd_rn(
      __fmul_rn(__fmul_rn(__fdiv_rn(__fsub_rn(zn0, vh), d0_safe),
                          __fsub_rn(ddest, zn2)),
                a.inv_k),
      vh);
  const float vd_z1 = ddest < __fmul_rn(1.5f, zn2) ? near : far;
  float vd = n1 ? vd_z1 : 0.0f;
  vd = n0 ? a.v_desired_default : vd;
  o.ndx = ndx;
  o.ndy = ndy;
  o.ndz = ndz;
  o.ptr = ptr;
  o.ddest = ddest;
  o.vd = vd;
  o.n0 = n0;
  o.n1 = n1;
  o.n2 = n2;
  o.zn0 = zn0;
  o.zn1 = zn1;
  o.zn2 = zn2;
  o.zn3 = zn3;
  return o;
}

// ops/forces.py dest_force_straight toward the pass's destination
__device__ __forceinline__ void straight_force(float x, float y,
                                               const NavPass& o, float* fx,
                                               float* fy) {
  const bool ok = o.ddest > 0.0f;
  const float safe = ok ? o.ddest : 1.0f;
  *fx = ok ? __fdiv_rn(__fmul_rn(-o.vd, __fsub_rn(x, o.ndx)), safe) : 0.0f;
  *fy = ok ? __fdiv_rn(__fmul_rn(-o.vd, __fsub_rn(y, o.ndy)), safe) : 0.0f;
}

// Row j's outputs after its destination force: the FSM fields of the pass
// `o` (an inactive row's held at the pre-step fields it was given:
// engine.py finish_step), then the pair packs (engine.py
// pack_pair_fields)
__device__ __forceinline__ void pre_outputs(
    const AgentPreArgs& a, int j, float x, float y, float psi, float v,
    int p0, bool z0, bool z1, bool z2, float d0x, float d0y, float d0z,
    const float* zp, const NavPass& o) {
  const bool live = a.active[j];
  a.dest_out[3 * j] = live ? o.ndx : d0x;
  a.dest_out[3 * j + 1] = live ? o.ndy : d0y;
  a.dest_out[3 * j + 2] = live ? o.ndz : d0z;
  a.ptr_out[j] = live ? o.ptr : p0;
  a.znav_out[3 * j] = live ? o.n0 : z0;
  a.znav_out[3 * j + 1] = live ? o.n1 : z1;
  a.znav_out[3 * j + 2] = live ? o.n2 : z2;
  float* zo = a.znavp_out + static_cast<size_t>(j) * 4;
  zo[0] = live ? o.zn0 : zp[0];
  zo[1] = live ? o.zn1 : zp[1];
  zo[2] = live ? o.zn2 : zp[2];
  zo[3] = live ? o.zn3 : zp[3];
  a.istop_out[j] = live ? o.istop : a.i_stopsignal[j];
  a.dstop_out[j] = live ? o.dstop : a.d_stopsignal[j];

  // engine.py pack_pair_fields
  float c[kSrcCols];
  const float act = live ? 1.0f : 0.0f;
  const int uid = a.uid[j];
  const float cp = cosf(psi), sp = sinf(psi);
  field_cols(a, v, act, uid, c);
  c[0] = x;
  c[1] = y;
  c[2] = cp;
  c[3] = sp;
  c[11] = cosf(__fmul_rn(col(a.cols[kHfov], uid), 0.5f));
  c[13] = a.legacy ? 1.0f : 0.0f;
  c[14] = 0.0f;
  c[15] = act;
  float* src = a.src_pack + static_cast<size_t>(j) * kSrcCols;
  for (int k = 0; k < kSrcCols; ++k) src[k] = c[k];
  const float recv[kRecvRows] = {x, y, cp, sp, act, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < kRecvRows; ++r) {
    a.recv_pack[static_cast<size_t>(r) * a.npad + j] = recv[r];
  }
}

// The twod model's spline destination force, agent_pre's spline instance.
//
// Replaces no TPU kernel: the JAX package's XLA program fuses this chain
// (cyclistsocialforce_tpu/engine.py dest_force_spline, ops/spline.py),
// which the port ran as ~800 PyTorch kernels a step, every [N, 6, 2] and
// [N, 20, 2] intermediate a round trip through memory, and the second
// queue/FSM pass of the fallback in every row.
//
// What bounds it. One thread per row reads ~350 bytes (agent_pre's ~240,
// two slots of the position ring, up to four queued points) and does
// ~1,250 FP32 operations (a row whose destination is its last evaluates
// the spline at the 20 points of the nearest-sample search; the others
// skip it, as only that row reads its argmin): ~0.01 ms of HBM traffic
// at 100,000 riders and ~0.002 ms of FP32 work, so bytes bound it, and
// the ~45 IEEE divisions a row, each a short sequence, sit beside them.
// The design keeps the fit in registers: the support points, the chord
// sites, the folded Thomas sweep over the 4 interior moments, the side
// table of `_interval_pieces` and its one-hot selects are unrolled over
// their static sizes. The fallback's second queue/FSM pass and straight
// line run in a branch, in the few rows that take it.
//
// Exactness: the file's header; besides, the chain's reductions in
// PyTorch's CUDA order. torch.cumsum over the 5 chord lengths is ATen's
// inner scan (ScanUtils.cuh), one Sklansky tree: c0 = x0 + 0, c1 = x1 +
// c0, c2 = x2 + c1, c3 = (x3 + x2) + c1, c4 = x4 + c3. A one-hot sum is
// its selected entry plus zeros (-0 comes out +0), and where it
// multiplies the one-hot in (`_interval_pieces`), NaN if any other
// interval's entry is not finite (0 x inf). torch.argmin takes the first
// NaN, else the first minimum. `** 2` and `** 3` are x * x and (x * x) *
// x.

// A spline of the force: the chord sites t, the interval widths h, the
// support points (px, py) and the moments (mx, my), and for each column
// of `_interval_pieces`' side table the intervals whose entry is not
// finite (bit i: interval i)
struct Spline {
  float t[6], h[5], px[6], py[6], mx[6], my[6];
  unsigned bad_h, bad_t0, bad_t1, bad_mx0, bad_mx1, bad_my0, bad_my1,
      bad_px0, bad_px1, bad_py0, bad_py1;
};

// The entries of v[0..4] that are not finite, as bits
__device__ __forceinline__ unsigned nonfinite5(const float* v) {
  unsigned b = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) b |= isfinite(v[i]) ? 0u : 1u << i;
  return b;
}

// ops/spline.py _interval_pieces' one-hot contraction over the 5
// intervals: entry k of v plus the other intervals' zero products, NaN
// where one of those is not finite
__device__ __forceinline__ float pick5(const float* v, unsigned bad, int k) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) r = k == i ? v[i] : r;
  return (bad & ~(1u << k)) ? __int_as_float(0x7fffffff)
                            : __fadd_rn(r, 0.0f);
}

// ops/spline.py _masked_sites and fit_masked_banded over the first m of
// the support points sp.px, sp.py: the sites, widths and moments, then
// the side table's non-finite entries
__device__ __forceinline__ void fit_spline(const AgentPreSplineArgs& a,
                                           int m, Spline& sp) {
  float seg[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float dx = __fsub_rn(sp.px[k + 1], sp.px[k]);
    const float dy = __fsub_rn(sp.py[k + 1], sp.py[k]);
    seg[k] = k < m - 1
                 ? __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)))
                 : 0.0f;
  }
  const float c0 = __fadd_rn(seg[0], 0.0f);
  const float c1 = __fadd_rn(seg[1], c0);
  const float c2 = __fadd_rn(seg[2], c1);
  const float c3 = __fadd_rn(__fadd_rn(seg[3], seg[2]), c1);
  const float c4 = __fadd_rn(seg[4], c3);
  const float cum[6] = {0.0f, c0, c1, c2, c3, c4};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    sp.t[k] = k < m ? __fdiv_rn(cum[k], c4) : static_cast<float>(k - m + 2);
  }
  const float* h = sp.h;
#pragma unroll
  for (int k = 0; k < 5; ++k) sp.h[k] = __fsub_rn(sp.t[k + 1], sp.t[k]);

  // the end moments' relations from the two not-a-knot rows
  const float p1 = __fdiv_rn(__fadd_rn(h[0], h[1]), h[1]);
  const float p2 = __fdiv_rn(-h[0], h[1]);
  float h_m3 = 0.0f, h_m2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    h_m3 = i == m - 3 ? h[i] : h_m3;
    h_m2 = i == m - 2 ? h[i] : h_m2;
  }
  h_m3 = __fadd_rn(h_m3, 0.0f);
  h_m2 = __fadd_rn(h_m2, 0.0f);
  const float q1 = __fdiv_rn(__fadd_rn(h_m3, h_m2), h_m3);
  const float q2 = __fdiv_rn(-h_m2, h_m3);

  // the interior rows: slot i live where i <= m - 3, a dead slot identity
  float sa[4], sb[4], sc[4], dx[4], dy[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = i <= m - 3;
    const float ddx = __fsub_rn(
        __fdiv_rn(__fsub_rn(sp.px[i + 2], sp.px[i + 1]), h[i + 1]),
        __fdiv_rn(__fsub_rn(sp.px[i + 1], sp.px[i]), h[i]));
    const float ddy = __fsub_rn(
        __fdiv_rn(__fsub_rn(sp.py[i + 2], sp.py[i + 1]), h[i + 1]),
        __fdiv_rn(__fsub_rn(sp.py[i + 1], sp.py[i]), h[i]));
    sa[i] = live ? __fmul_rn(h[i], a.sixth) : 0.0f;
    sb[i] = live ? __fmul_rn(__fadd_rn(h[i], h[i + 1]), a.third) : 1.0f;
    sc[i] = live ? __fmul_rn(h[i + 1], a.sixth) : 0.0f;
    dx[i] = live ? ddx : 0.0f;
    dy[i] = live ? ddy : 0.0f;
  }
  // the end relations folded into the first and last live rows
  const float a0 = sa[0];
  sb[0] = __fadd_rn(sb[0], __fmul_rn(a0, p1));
  sc[0] = __fadd_rn(sc[0], __fmul_rn(a0, p2));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool last = i == m - 3;
    sb[i] = __fadd_rn(sb[i], last ? __fmul_rn(sc[i], q1) : 0.0f);
    sa[i] = __fadd_rn(sa[i], last ? __fmul_rn(sc[i], q2) : 0.0f);
    sc[i] = last ? 0.0f : sc[i];
  }
  sa[0] = 0.0f;

  // the Thomas sweep over the 4 slots, both coordinates
  const float cp0 = __fdiv_rn(sc[0], sb[0]);
  const float den1 = __fsub_rn(sb[1], __fmul_rn(sa[1], cp0));
  const float cp1 = __fdiv_rn(sc[1], den1);
  const float den2 = __fsub_rn(sb[2], __fmul_rn(sa[2], cp1));
  const float cp2 = __fdiv_rn(sc[2], den2);
  const float den3 = __fsub_rn(sb[3], __fmul_rn(sa[3], cp2));
  float* mm[2] = {sp.mx, sp.my};
  const float* dd[2] = {dx, dy};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* d = dd[c];
    const float dp0 = __fdiv_rn(d[0], sb[0]);
    const float dp1 =
        __fdiv_rn(__fsub_rn(d[1], __fmul_rn(sa[1], dp0)), den1);
    const float dp2 =
        __fdiv_rn(__fsub_rn(d[2], __fmul_rn(sa[2], dp1)), den2);
    const float dp3 =
        __fdiv_rn(__fsub_rn(d[3], __fmul_rn(sa[3], dp2)), den3);
    const float m3 = dp3;
    const float m2 = __fsub_rn(dp2, __fmul_rn(cp2, m3));
    const float m1 = __fsub_rn(dp1, __fmul_rn(cp1, m2));
    const float m0 = __fsub_rn(dp0, __fmul_rn(cp0, m1));
    float* M = mm[c];
    M[1] = 0 <= m - 3 ? m0 : 0.0f;
    M[2] = 1 <= m - 3 ? m1 : 0.0f;
    M[3] = 2 <= m - 3 ? m2 : 0.0f;
    M[4] = 3 <= m - 3 ? m3 : 0.0f;
    M[5] = 0.0f;
    M[0] = __fadd_rn(__fmul_rn(p1, M[1]), __fmul_rn(p2, M[2]));
    float m_m2 = 0.0f, m_m3 = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      m_m2 = i == m - 2 ? M[i] : m_m2;
      m_m3 = i == m - 3 ? M[i] : m_m3;
    }
    const float m_end = __fadd_rn(__fmul_rn(q1, __fadd_rn(m_m2, 0.0f)),
                                  __fmul_rn(q2, __fadd_rn(m_m3, 0.0f)));
#pragma unroll
    for (int i = 0; i < 6; ++i) M[i] = i == m - 1 ? m_end : M[i];
  }

  sp.bad_h = nonfinite5(sp.h);
  sp.bad_t0 = nonfinite5(sp.t);
  sp.bad_t1 = nonfinite5(sp.t + 1);
  sp.bad_mx0 = nonfinite5(sp.mx);
  sp.bad_mx1 = nonfinite5(sp.mx + 1);
  sp.bad_my0 = nonfinite5(sp.my);
  sp.bad_my1 = nonfinite5(sp.my + 1);
  sp.bad_px0 = nonfinite5(sp.px);
  sp.bad_px1 = nonfinite5(sp.px + 1);
  sp.bad_py0 = nonfinite5(sp.py);
  sp.bad_py1 = nonfinite5(sp.py + 1);
}

// One interval k of ops/spline.py _interval_pieces' side table, as its
// one-hot contraction selects it (`pick5`): the width (and 6 times it),
// the sites at its ends, the moments and, from them and the values,
// spline_eval's a and b
struct Interval {
  float hk, hk6, tk0, tk1, mk[2], mk1[2], a[2], b[2];
};

__device__ __forceinline__ Interval interval(const Spline& sp, int k,
                                             float sixth) {
  Interval iv;
  iv.hk = pick5(sp.h, sp.bad_h, k);
  iv.hk6 = __fmul_rn(iv.hk, 6.0f);
  iv.tk0 = pick5(sp.t, sp.bad_t0, k);
  iv.tk1 = pick5(sp.t + 1, sp.bad_t1, k);
  const float yk[2] = {pick5(sp.px, sp.bad_px0, k),
                       pick5(sp.py, sp.bad_py0, k)};
  const float yk1[2] = {pick5(sp.px + 1, sp.bad_px1, k),
                        pick5(sp.py + 1, sp.bad_py1, k)};
  iv.mk[0] = pick5(sp.mx, sp.bad_mx0, k);
  iv.mk[1] = pick5(sp.my, sp.bad_my0, k);
  iv.mk1[0] = pick5(sp.mx + 1, sp.bad_mx1, k);
  iv.mk1[1] = pick5(sp.my + 1, sp.bad_my1, k);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    iv.a[c] = __fsub_rn(__fdiv_rn(yk[c], iv.hk),
                        __fmul_rn(__fmul_rn(iv.mk[c], iv.hk), sixth));
    iv.b[c] = __fsub_rn(__fdiv_rn(yk1[c], iv.hk),
                        __fmul_rn(__fmul_rn(iv.mk1[c], iv.hk), sixth));
  }
  return iv;
}

// _interval_pieces' interval of query q: the sites strictly below q, less
// one, clamped to 0..4
__device__ __forceinline__ int interval_of(const Spline& sp, float q) {
  int count = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) count += q > sp.t[i] ? 1 : 0;
  return min(max(count - 1, 0), 4);
}

// ops/spline.py spline_eval: the position's coordinate c at query q of
// interval iv
__device__ __forceinline__ float interval_pos(const Interval& iv, float q,
                                              int c) {
  const float t1 = __fsub_rn(iv.tk1, q);
  const float t2 = __fsub_rn(q, iv.tk0);
  const float t13 = __fmul_rn(__fmul_rn(t1, t1), t1);
  const float t23 = __fmul_rn(__fmul_rn(t2, t2), t2);
  return __fadd_rn(
      __fadd_rn(__fdiv_rn(__fadd_rn(__fmul_rn(iv.mk[c], t13),
                                    __fmul_rn(iv.mk1[c], t23)),
                          iv.hk6),
                __fmul_rn(iv.a[c], t1)),
      __fmul_rn(iv.b[c], t2));
}

// the nearest-sample grid's parameter k: k / 19 as torch.arange(19) times
// the float of 1 / 19, then 1 (ops/spline.py uniform_grid)
__device__ __forceinline__ float grid_param(int k, float q_step) {
  return k == 19 ? 1.0f : __fmul_rn(static_cast<float>(k), q_step);
}

// engine.py dest_force_spline for row j (the first pass of the queue
// update and FSM in *o): the force (fx, fy), and in *o the pass the row
// keeps, the second where it falls back to the straight line. `live`:
// the row is active.
__device__ __forceinline__ void spline_force(
    const AgentPreSplineArgs& a, int j, const float* dq, float x, float y,
    float psi, float v, int nq, int i_step, bool live, NavPass* o,
    float* fx, float* fy) {
  const NavPass o1 = *o;
  // the ring's slots of global steps t - 1 and t - min(t, lookback)
  const int tg = a.t_glob[0];
  int s_prev = (tg - 1) % a.hist;
  s_prev += s_prev < 0 ? a.hist : 0;
  int s_back = (tg - min(tg, a.lookback)) % a.hist;
  s_back += s_back < 0 ? a.hist : 0;
  const float* ph = a.pos_hist + static_cast<size_t>(j) * a.hist * 2;

  // the support points: not-last (prev, current, the queue from the
  // pointer on, fwd = min(nq - ptr, 4) of them valid); last (1 s back,
  // prev, current, the destination)
  Spline sp;
  const bool is_last = o1.ptr >= nq - 1;
  int m;
  if (is_last) {
    const float px[6] = {ph[2 * s_back], ph[2 * s_prev], x, o1.ndx, 0.0f,
                         0.0f};
    const float py[6] = {ph[2 * s_back + 1], ph[2 * s_prev + 1], y, o1.ndy,
                         0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      sp.px[k] = px[k];
      sp.py[k] = py[k];
    }
    m = 4;
  } else {
    sp.px[0] = ph[2 * s_prev];
    sp.py[0] = ph[2 * s_prev + 1];
    sp.px[1] = x;
    sp.py[1] = y;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = min(max(o1.ptr + k, 0), a.q - 1);
      sp.px[2 + k] = dq[3 * p];
      sp.py[2 + k] = dq[3 * p + 1];
    }
    m = 2 + min(nq - o1.ptr, 4);
  }
  fit_spline(a, m, sp);

  // the nearest of the 20 samples, read by a last-destination row only
  // (the 5 intervals computed once for its 20 samples)
  int i_spl = 1;
  if (is_last) {
    Interval ivs[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) ivs[k] = interval(sp, k, a.sixth);
    float best = 0.0f;
#pragma unroll 1
    for (int k = 0; k < 20; ++k) {
      const float q = grid_param(k, a.q_step);
      const Interval& iv = ivs[interval_of(sp, q)];
      const float ex = __fsub_rn(interval_pos(iv, q, 0), x);
      const float ey = __fsub_rn(interval_pos(iv, q, 1), y);
      const float d2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      if (k == 0 || (!isnan(best) && (isnan(d2) || d2 < best))) {
        best = d2;
        i_spl = k;
      }
    }
  }
  const int ipred = i_spl + (o1.ndz > 0.0f ? 5 : 3);
  const float qi = grid_param(i_spl, a.q_step);
  const float qp = grid_param(min(ipred, 19), a.q_step);
  const Interval pi = interval(sp, interval_of(sp, qi), a.sixth);
  const Interval pp = interval(sp, interval_of(sp, qp), a.sixth);

  // the derivatives at the sample, the curvature's speed limit, the force
  // along the chord to the look-ahead point
  float ds[2], d2s[2];
  const float t1 = __fsub_rn(pi.tk1, qi);
  const float t2 = __fsub_rn(qi, pi.tk0);
  const float t1sq = __fmul_rn(t1, t1);
  const float t2sq = __fmul_rn(t2, t2);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    ds[c] = __fadd_rn(
        __fsub_rn(__fdiv_rn(__fadd_rn(__fmul_rn(-pi.mk[c], t1sq),
                                      __fmul_rn(pi.mk1[c], t2sq)),
                            __fmul_rn(pi.hk, 2.0f)),
                  pi.a[c]),
        pi.b[c]);
    d2s[c] = __fdiv_rn(__fadd_rn(__fmul_rn(pi.mk[c], t1),
                                 __fmul_rn(pi.mk1[c], t2)),
                       pi.hk);
  }
  const float sq = norm_rn(ds[0], ds[1]);
  const float r_curve = __fdiv_rn(
      __fmul_rn(__fmul_rn(sq, sq), sq),
      fabsf(__fsub_rn(__fmul_rn(ds[0], d2s[1]), __fmul_rn(ds[1], d2s[0]))));
  const float v_curve =
      clamp_min(__fsqrt_rn(__fmul_rn(a.tc_g, r_curve)), a.v_stable);
  // torch.minimum: a NaN operand wins
  const float v_spl = isnan(v_curve) ? v_curve
                      : isnan(o1.vd) ? o1.vd
                                     : fminf(v_curve, o1.vd);
  const float segx =
      __fsub_rn(interval_pos(pp, qp, 0), interval_pos(pi, qi, 0));
  const float segy =
      __fsub_rn(interval_pos(pp, qp, 1), interval_pos(pi, qi, 1));
  const float seg_len = norm_rn(segx, segy);
  const float safe = seg_len > 0.0f ? seg_len : 1.0f;
  const float fsx = __fdiv_rn(__fmul_rn(v_spl, segx), safe);
  const float fsy = __fdiv_rn(__fmul_rn(v_spl, segy), safe);

  // precedence: step 0 (along the heading), arrived (none), the fallback,
  // the spline; an inactive row never falls back
  const bool fb = (ipred >= 20 || !(isfinite(fsx) && isfinite(fsy))) &&
                  !o1.n2 && i_step > 0 && live;
  *fx = i_step == 0 ? __fmul_rn(o1.vd, cosf(psi)) : (o1.n2 ? 0.0f : fsx);
  *fy = i_step == 0 ? __fmul_rn(o1.vd, sinf(psi)) : (o1.n2 ? 0.0f : fsy);
  if (fb) {
    // the second pass of the queue update and FSM, then the straight line
    const float zp1[4] = {o1.zn0, o1.zn1, o1.zn2, o1.zn3};
    *o = nav_pass(a, dq, x, y, v, nq, i_step, o1.ptr, o1.n0, o1.n1, o1.n2,
                  o1.ndx, o1.ndy, o1.ndz, zp1, &o1.istop, &o1.dstop);
    straight_force(x, y, *o, fx, fy);
  }
}

template <bool kSpline>
using PreArgs = std::conditional_t<kSpline, AgentPreSplineArgs, AgentPreArgs>;

template <bool kSpline>
__global__ void __launch_bounds__(kThreads)
    agent_pre_kernel(const PreArgs<kSpline> a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.npad) return;
  if (j >= a.n) {
    // a pad row: inactive at row 0's position with row 0's field columns
    // and zero amplitude (engine.py pack_pair_fields)
    float c[kSrcCols];
    field_cols(a, a.s[3], a.active[0] ? 1.0f : 0.0f, a.uid[0], c);
    float* src = a.src_pack + static_cast<size_t>(j) * kSrcCols;
    for (int k = 0; k < kSrcCols; ++k) src[k] = 0.0f;
    src[0] = a.s[0];
    src[1] = a.s[1];
    for (int k = 5; k < 11; ++k) src[k] = c[k];
    for (int r = 0; r < kRecvRows; ++r) {
      a.recv_pack[static_cast<size_t>(r) * a.npad + j] =
          r == 0 ? a.s[0] : (r == 1 ? a.s[1] : 0.0f);
    }
    return;
  }
  const float* s = a.s + static_cast<size_t>(j) * 8;
  const float x = s[0], y = s[1], psi = s[2], v = s[3];
  const float* dq = a.destqueue + static_cast<size_t>(j) * a.q * 3;
  const int p0 = a.destpointer[j];
  const int nq = a.nq[j];
  const bool z0 = a.znav[3 * j], z1 = a.znav[3 * j + 1],
             z2 = a.znav[3 * j + 2];
  const float d0x = a.dest[3 * j], d0y = a.dest[3 * j + 1],
              d0z = a.dest[3 * j + 2];
  const int i_step = a.i_step[j];
  const float* zp = a.znavparams + static_cast<size_t>(j) * 4;
  NavPass o = nav_pass(a, dq, x, y, v, nq, i_step, p0, z0, z1, z2, d0x, d0y,
                       d0z, zp, a.i_stopsignal + j, a.d_stopsignal + j);
  float fdx, fdy;
  if constexpr (kSpline) {
    // the spline (and in a fallback row the second pass) replaces `o`
    spline_force(a, j, dq, x, y, psi, v, nq, i_step, a.active[j], &o, &fdx,
                 &fdy);
  } else {
    straight_force(x, y, o, &fdx, &fdy);
  }
  a.fdx[j] = fdx;
  a.fdy[j] = fdy;
  pre_outputs(a, j, x, y, psi, v, p0, z0, z1, z2, d0x, d0y, d0z, zp, o);
}

// The row of element e of a span of rows of w columns (inv_w = 1 / w,
// rounded): (e + 0.5) / w lies at least 0.5 / w from an integer, far
// beyond float's error for spans of a warp's rows.
__device__ __forceinline__ int row_of(int e, float inv_w) {
  return static_cast<int>((static_cast<float>(e) + 0.5f) * inv_w);
}

// agent_post's step of row j (`s`: its pre-step state): ops/forces.py
// clamp_add_dest (the applied force written out), then models/bicycle2d.py
// control and move: the state's first five columns moved, the P errors
// and integrals of steer and speed
__device__ __forceinline__ void kinematic_step(const AgentPostArgs& a, int j,
                                               const float* s,
                                               float* moved, float* e,
                                               float* i) {
  const float inv_two_pi = __fdiv_rn(1.0f, kTwoPi);

  // ops/forces.py clamp_add_dest (utils/angles.py limit_magnitude)
  const float fdx = a.fdx[j], fdy = a.fdy[j];
  float frx = a.frx[j], fry = a.fry[j];
  const float r = norm_rn(fdx, fdy);
  const float rin = norm_rn(frx, fry);
  const float scale =
      rin > r ? __fdiv_rn(r, rin > 0.0f ? rin : 1.0f) : 1.0f;
  frx = __fmul_rn(frx, scale);
  fry = __fmul_rn(fry, scale);
  const float fx = __fadd_rn(frx, fdx);
  const float fy = __fadd_rn(fry, fdy);
  a.fx[j] = fx;
  a.fy[j] = fy;

  // models/bicycle2d.py control, on the state agent_pre updated
  const float theta = atan2f(fy, fx);
  float v_cmd = norm_rn(fx, fy);
  const float ddest =
      norm_rn(__fsub_rn(a.dest[3 * j], s[0]), __fsub_rn(a.dest[3 * j + 1],
                                                        s[1]));
  const bool is_last = a.destpointer[j] + 1 >= a.nq[j];
  if (ddest < 3.0f && is_last) {
    // v_cmd / 3.0: times the float reciprocal, as a Python float divides
    v_cmd = __fmul_rn(__fmul_rn(v_cmd, __fdiv_rn(1.0f, 3.0f)), ddest);
  }
  const float target = angle_difference(s[2], theta, inv_two_pi);
  const float ddelta = angle_difference(s[4], target, inv_two_pi);
  const float dv = __fsub_rn(v_cmd, s[3]);
  float i0, i1;
  const float odelta = pid_p(ddelta, a.pid_e[2 * j], a.pid_i[2 * j],
                             a.k_p_delta, a.t_s, a.inv_t_s, &i0);
  float acc = pid_p(dv, a.pid_e[2 * j + 1], a.pid_i[2 * j + 1], a.k_p_v,
                    a.t_s, a.inv_t_s, &i1);

  // models/bicycle2d.py move
  acc = thresh(acc, a.a_max_lo, a.a_max_hi);
  float delta = limit_angle(__fadd_rn(s[4], __fmul_rn(a.t_s, odelta)),
                            inv_two_pi);
  float v = __fadd_rn(s[3], __fmul_rn(a.t_s, acc));
  delta = thresh(delta, a.neg_delta_max, a.delta_max);
  v = thresh(v, a.v_max_lo, a.v_max_hi);
  const float tv = __fmul_rn(a.t_s, v);
  const float psi = limit_angle(
      __fadd_rn(s[2], __fmul_rn(__fmul_rn(tv, tanf(delta)), a.inv_l)),
      inv_two_pi);
  const float ny = __fadd_rn(s[1], __fmul_rn(tv, sinf(psi)));
  const float nx = __fadd_rn(s[0], __fmul_rn(tv, cosf(psi)));
  moved[0] = nx;
  moved[1] = ny;
  moved[2] = psi;
  moved[3] = v;
  moved[4] = delta;
  e[0] = ddelta;
  e[1] = dv;
  i[0] = i0;
  i[1] = i1;
}

// The twod instance's bookkeeping (models/bicycle_twod.py step, engine.py
// finish_step): an arrived row holds its position and heading with speed,
// steer and roll zero, and its P memories; an inactive row its pre-step
// state. The position ring, ~2 KB of a row's ~2.3 KB at H = 128, is
// copied a warp at a time: lane l moves the (x, y) slots l, l + rows, ...
// of the warp's rows' contiguous span (rows: the warp's live rows, 32 but
// in the last warp), so each access of a whole warp is 256 contiguous
// bytes, where a thread copying its own row would stride the warp's lanes
// 2 H x 4 bytes apart; and kRingBatch loads are in flight before their
// stores, since a store that may alias the next load would otherwise
// hold that load back for a whole round trip to memory.
constexpr int kRingBatch = 8;

__device__ __forceinline__ void twod_finish(const AgentPostTwodArgs& a,
                                            int j, const float* s,
                                            const float* moved,
                                            const float* e, const float* i) {
  __shared__ float2 pbuf[kThreads];      // the rows' new positions
  const bool act = a.active[j];
  const bool arrived = a.znav[3 * j + 2];
  float so[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float frozen = k == 3 || k == 4 || k == 5 ? 0.0f : s[k];
    so[k] = !act ? s[k] : (arrived ? frozen : (k < 5 ? moved[k] : s[k]));
  }
  float* out = a.s_out + static_cast<size_t>(j) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = so[k];
  const bool ctl = act && !arrived;
  a.pid_e_out[2 * j] = ctl ? e[0] : a.pid_e[2 * j];
  a.pid_e_out[2 * j + 1] = ctl ? e[1] : a.pid_e[2 * j + 1];
  a.pid_i_out[2 * j] = ctl ? i[0] : a.pid_i[2 * j];
  a.pid_i_out[2 * j + 1] = ctl ? i[1] : a.pid_i[2 * j + 1];
  a.i_out[j] = a.i_step[j] + (act ? 1 : 0);

  const int lane = threadIdx.x % 32;
  const int r0 = j - lane;
  const int rows = min(32, a.n - r0);
  const float2* wbuf = pbuf + (threadIdx.x - lane);
  pbuf[threadIdx.x] = make_float2(so[0], so[1]);
  __syncwarp(rows >= 32 ? 0xffffffffu : (1u << rows) - 1u);
  const int hist = a.hist;
  int slot = (a.t_glob[0] + 1) % hist;
  slot = slot < 0 ? slot + hist : slot;
  const float inv_h = __frcp_rn(static_cast<float>(hist));
  const size_t first = static_cast<size_t>(r0) * hist;
  const float2* ph = reinterpret_cast<const float2*>(a.pos_hist) + first;
  float2* po = reinterpret_cast<float2*>(a.pos_hist_out) + first;
  const int total = rows * hist;
  for (int k0 = lane; k0 < total; k0 += kRingBatch * rows) {
    float2 v[kRingBatch];
#pragma unroll
    for (int b = 0; b < kRingBatch; ++b) {
      const int k = k0 + b * rows;
      if (k < total) v[b] = ph[k];
    }
#pragma unroll
    for (int b = 0; b < kRingBatch; ++b) {
      const int k = k0 + b * rows;
      if (k < total) {
        const int r = row_of(k, inv_h);
        po[k] = k - r * hist == slot ? wbuf[r] : v[b];
      }
    }
  }
}

template <bool kFreeze>
using PostArgs = std::conditional_t<kFreeze, AgentPostTwodArgs, AgentPostArgs>;

template <bool kFreeze>
__global__ void __launch_bounds__(kThreads)
    agent_post_kernel(const PostArgs<kFreeze> a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j == 0) a.t_out[0] = a.t_glob[0] + 1;
  if (j >= a.n) return;
  const float* s = a.s + static_cast<size_t>(j) * 8;
  float moved[5], e[2], i[2];
  kinematic_step(a, j, s, moved, e, i);
  if constexpr (kFreeze) {
    twod_finish(a, j, s, moved, e, i);
    return;
  }

  // engine.py finish_step: an inactive row holds its pre-step state (its
  // FSM fields, agent_pre's, already do)
  const bool act = a.active[j];
  float* so = a.s_out + static_cast<size_t>(j) * 8;
  for (int k = 0; k < 8; ++k) so[k] = act && k < 5 ? moved[k] : s[k];
  a.pid_e_out[2 * j] = act ? e[0] : a.pid_e[2 * j];
  a.pid_e_out[2 * j + 1] = act ? e[1] : a.pid_e[2 * j + 1];
  a.pid_i_out[2 * j] = act ? i[0] : a.pid_i[2 * j];
  a.pid_i_out[2 * j + 1] = act ? i[1] : a.pid_i[2 * j + 1];
  a.i_out[j] = a.i_step[j] + (act ? 1 : 0);

  // the position ring, copied, its slot (t_glob + 1) % H written
  int slot = (a.t_glob[0] + 1) % a.hist;
  slot = slot < 0 ? slot + a.hist : slot;
  const float* ph = a.pos_hist + static_cast<size_t>(j) * a.hist * 2;
  float* po = a.pos_hist_out + static_cast<size_t>(j) * a.hist * 2;
  for (int h = 0; h < a.hist; ++h) {
    po[2 * h] = h == slot ? so[0] : ph[2 * h];
    po[2 * h + 1] = h == slot ? so[1] : ph[2 * h + 1];
  }
}

// The balancing rider's step after the pair kernel.
//
// Replaces no TPU kernel: the JAX package's XLA program fuses this chain
// (cyclistsocialforce_tpu/models/balancingrider.py step, ops/smallmat.py
// solve_small, ops/piecewise.py, engine.py finish_step), which the port ran
// as ~500 PyTorch kernels a step, every [N, 5, 5] intermediate a round trip
// through memory.
//
// What bounds it. One thread per row reads ~190 bytes (the state, the
// bike frame's latents, the cached gains, the four forces, the counter and
// the position ring) and writes ~190 (the same fields out of place: the
// ring copied with one slot new) against ~560 FP32 operations: ~0.011 ms
// of HBM traffic at 100,000 riders on an H100's 3.35 TB/s and ~0.001 ms of
// FP32 work, so bytes bound it. The design keeps the work from touching
// memory at all: A(v) - B K, the 5x6 augmented matrix and its elimination
// live in registers, unrolled over the static size (no local memory: the
// pivot's row swap is a select per row, not an indexed store), and the
// constants a thread reads at a speed of its own (the fit's coefficients
// at its segment, A0, A1, A2, B) are staged once per block in shared
// memory, so each row's memory traffic is its own fields, read and
// written once. The row-major fields (the state, the latents, the gains
// rows, the position ring) move between memory and a warp's 32 rows
// through shared memory or lane by lane over the rows' contiguous span,
// so each access of the warp is whole 128-byte lines: a thread storing
// its own 32-byte row column by column would write a partial sector per
// store, eight times the traffic between L1 and L2.
//
// Exactness, as agent_post's: each operation is the plain PyTorch
// version's, rounded as its CUDA kernel rounds, in its order (the file's
// header); the build does not contract (-fmad=false). torch.sum over the
// five products of a matvec row adds in the order of PyTorch's CUDA
// reduction (`sum5`); the pivot is torch.argmax's, the first of equal
// magnitudes; a row picked by a one-hot sum is normalised as that sum
// normalises it (-0 + 0 = +0).

// torch.sum over a contiguous axis of 5 (ATen's Reduce.cuh): four lanes
// an output, lane l adding elements l and l + 4 into an accumulator that
// starts at +0, then the lanes combined by a warp shuffle of offsets 2,
// then 1
__device__ __forceinline__ float sum5(const float* p) {
  const float l0 = __fadd_rn(__fadd_rn(0.0f, p[0]), __fadd_rn(0.0f, p[4]));
  const float l1 = __fadd_rn(0.0f, p[1]);
  const float l2 = __fadd_rn(0.0f, p[2]);
  const float l3 = __fadd_rn(0.0f, p[3]);
  return __fadd_rn(__fadd_rn(l0, l2), __fadd_rn(l1, l3));
}

// ops/piecewise.py eval_piecewise_poly: the five gains at speed v from
// the fit's coefficient matrix c ([5 * deg1, segs], staged), the segment
// clamped as an integer and each output a Horner chain
__device__ __forceinline__ void gains_poly(const AgentPostWhippleArgs& a,
                                           const float* c, float v,
                                           float* k) {
  float x = __fmul_rn(__fsub_rn(v, a.poly_lo), a.inv_seg_dv);
  // torch.clamp(x, 0, segs - 1e-6): min(max(x, lo), hi), NaN passes
  x = isnan(x) ? x : fminf(fmaxf(x, 0.0f), a.x_max);
  int seg = isnan(x) ? 0 : static_cast<int>(floorf(x));
  seg = seg < 0 ? 0 : (seg > a.segs - 1 ? a.segs - 1 : seg);
  const float u = __fsub_rn(x, static_cast<float>(seg));
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const float* cm = c + static_cast<size_t>(a.deg1) * m * a.segs + seg;
    float acc = cm[static_cast<size_t>(a.deg1 - 1) * a.segs];
    for (int d = a.deg1 - 2; d >= 0; --d) {
      acc = __fadd_rn(__fmul_rn(acc, u), cm[static_cast<size_t>(d) * a.segs]);
    }
    k[m] = acc;
  }
}

// Per-warp staging in shared memory, after the block's constants: a
// [32, kLd] buffer for a row-major field of up to 8 columns (the odd
// stride lets each lane read or write its own row without bank
// conflicts), then the 32 rows' gains and their new positions.
constexpr int kWarps = kThreads / 32;
constexpr int kLd = 9;
constexpr int kWarpFloats = 32 * kLd + 32 * 5 + 32 * 2;

// The warp's rows [r0, r0 + rows) of a row-major [n, W] field, between
// global memory (`g`, row r0's first element) and the staging buffer:
// lane l moves elements l, l + 32, ... of the rows' contiguous span, so
// each access of the warp is 128 contiguous bytes.
template <int W>
__device__ __forceinline__ void warp_load(float* buf, const float* g,
                                          int rows, int lane) {
  for (int e = lane; e < rows * W; e += 32) buf[e / W * kLd + e % W] = g[e];
}

template <int W>
__device__ __forceinline__ void warp_store(float* g, const float* buf,
                                           int rows, int lane) {
  for (int e = lane; e < rows * W; e += 32) g[e] = buf[e / W * kLd + e % W];
}

__global__ void __launch_bounds__(kThreads)
    agent_post_kernel_whipple(const AgentPostWhippleArgs a) {
  extern __shared__ float sh[];
  const int ncoef = 5 * a.deg1 * a.segs;
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kThreads + threadIdx.x - lane;  // warp's row 0
  const int rows = min(32, a.n - r0);   // the warp's rows (<= 0: none)
  const int j = r0 + lane;
  const bool row = lane < rows;
  // a lane past the last row computes on the warp's row 0 and stores
  // nothing
  const int jr = row ? j : r0;
  const int me = row ? lane : 0;
  float* buf = sh + 80 + ncoef + (threadIdx.x / 32) * kWarpFloats;
  float* kbuf = buf + 32 * kLd;
  float* pbuf = kbuf + 32 * 5;

  // The row's inputs, loaded before anything is stored (a load the
  // compiler cannot move above a store would stand alone in the row's
  // chain), in flight while the block stages the constants.
  float s[8], x[7], kc[5], fdx, fdy, frx, fry, dyn_v;
  int i_step;
  bool act;
  if (rows > 0) {
    warp_load<8>(buf, a.s + static_cast<size_t>(r0) * 8, rows, lane);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = buf[me * kLd + c];
    __syncwarp();
    warp_load<7>(buf, a.dyn_x + static_cast<size_t>(r0) * 7, rows, lane);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 7; ++c) x[c] = buf[me * kLd + c];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      kc[c] = a.dyn_gains[static_cast<size_t>(jr) * a.gains + c];
    }
    fdx = a.fdx[jr];
    fdy = a.fdy[jr];
    frx = a.frx[jr];
    fry = a.fry[jr];
    dyn_v = a.dyn_v[jr];
    i_step = a.i_step[jr];
    act = a.active[jr];
  }
  const int t_glob = a.t_glob[0];

  // the constants, once per block: A0, A1, A2 (25 each), B (5), the fit
  // ([5 * deg1, segs], row-major)
  for (int k = threadIdx.x; k < 80 + ncoef; k += kThreads) {
    const int e = k - 80;
    sh[k] = k < 25   ? a.a0[k]
            : k < 50 ? a.a1[k - 25]
            : k < 75 ? a.a2[k - 50]
            : k < 80 ? a.b[k - 75]
                     : a.coeffs[static_cast<size_t>(e / a.segs) * a.coeff_row +
                                static_cast<size_t>(e % a.segs) * a.coeff_seg];
  }
  __syncthreads();
  const float* A0 = sh;
  const float* A1 = sh + 25;
  const float* A2 = sh + 50;
  const float* B = sh + 75;

  if (j == 0) a.t_out[0] = t_glob + 1;
  if (rows <= 0) return;
  const float inv_two_pi = __fdiv_rn(1.0f, kTwoPi);

  float fx, fy;
  clamp_add_dest(fdx, fdy, frx, fry, &fx, &fy);

  // models/balancingrider.py step: the speed's P control and Euler step
  const float v_old = s[3];
  const float acc = thresh(__fmul_rn(a.k_p_v, __fsub_rn(norm_rn(fx, fy),
                                                        v_old)),
                           a.a_max_lo, a.a_max_hi);
  const float v_new = thresh(__fadd_rn(v_old, __fmul_rn(a.t_s, acc)),
                             a.v_max_lo, a.v_max_hi);
  const float v_mid = __fmul_rn(__fadd_rn(v_new, v_old), 0.5f);

  // the commanded yaw in the bike frame
  const float psi_f = limit_angle(atan2f(-fy, fx), inv_two_pi);
  const float psi_c =
      __fadd_rn(x[4], angle_difference(x[4], psi_f, inv_two_pi));

  // the gains: the fit at the midpoint speed where the speed changed,
  // else the cache
  float k[5];
  if (v_new != v_old) {
    gains_poly(a, sh + 80, v_mid, k);
  } else {
#pragma unroll
    for (int c = 0; c < 5; ++c) k[c] = kc[c];
  }

  // Acl = A(v_mid) - B K; the augmented matrix [I - h/2 Acl | rhs] with
  // rhs = x5 + h/2 Acl x5 + h B (K_4 psi_c)
  const float vv = __fmul_rn(v_mid, v_mid);
  const float u = __fmul_rn(k[4], psi_c);
  float m[5][6];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    float acl[5], prod[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int e = 5 * r + c;
      const float av = __fadd_rn(__fadd_rn(A0[e], __fmul_rn(v_mid, A1[e])),
                                 __fmul_rn(vv, A2[e]));
      acl[c] = __fsub_rn(av, __fmul_rn(B[r], k[c]));
      prod[c] = __fmul_rn(acl[c], x[c]);
      m[r][c] = __fsub_rn(r == c ? 1.0f : 0.0f, __fmul_rn(a.half_t_s, acl[c]));
    }
    m[r][5] = __fadd_rn(__fadd_rn(x[r], __fmul_rn(a.half_t_s, sum5(prod))),
                        __fmul_rn(a.t_s, __fmul_rn(B[r], u)));
  }

  // ops/smallmat.py solve_small: partial pivoting, then elimination below
  // the pivot (every row updated, as the plain version's whole-matrix
  // update), then back substitution
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) {
    int p = kk;
    float best = fabsf(m[kk][kk]);
#pragma unroll
    for (int r = kk + 1; r < 5; ++r) {
      const float c = fabsf(m[r][kk]);
      if (c > best || (isnan(c) && !isnan(best))) {
        p = r;
        best = c;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float vp = m[kk][c];
#pragma unroll
      for (int r = kk + 1; r < 5; ++r) vp = p == r ? m[r][c] : vp;
      const float vk = __fadd_rn(m[kk][c], 0.0f);
      m[kk][c] = __fadd_rn(vp, 0.0f);
#pragma unroll
      for (int r = kk + 1; r < 5; ++r) m[r][c] = p == r ? vk : m[r][c];
    }
    float f[5], pivot_row[6];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      f[r] = r > kk ? __fdiv_rn(m[r][kk], m[kk][kk]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) pivot_row[c] = m[kk][c];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        m[r][c] = __fsub_rn(m[r][c], __fmul_rn(f[r], pivot_row[c]));
      }
    }
  }
  float xn[5];
#pragma unroll
  for (int r = 4; r >= 0; --r) {
    float acc_r = m[r][5];
#pragma unroll
    for (int c = r + 1; c < 5; ++c) {
      acc_r = __fsub_rn(acc_r, __fmul_rn(m[r][c], xn[c]));
    }
    xn[r] = __fdiv_rn(acc_r, m[r][r]);
  }

  // the positions at the midpoint yaw
  const float psi_mid = __fmul_rn(__fadd_rn(x[4], xn[4]), 0.5f);
  const float hv = __fmul_rn(a.t_s, v_mid);
  const float px = __fadd_rn(x[5], __fmul_rn(hv, cosf(psi_mid)));
  const float py = __fadd_rn(x[6], __fmul_rn(hv, sinf(psi_mid)));

  // models/balancingrider.py _finish (the frame flip) and engine.py
  // finish_step: an inactive row holds its pre-step state. The row-major
  // fields go out through the warp's buffer, a row's new gains and
  // positions through kbuf and pbuf.
  const float moved[8] = {px,
                          -py,
                          -limit_angle(xn[4], inv_two_pi),
                          v_new,
                          -limit_angle(xn[1], inv_two_pi),
                          limit_angle(xn[0], inv_two_pi),
                          -xn[3],
                          xn[2]};
  const float latents[7] = {xn[0], xn[1], xn[2], xn[3], xn[4], px, py};
  if (row) {
    a.fx[j] = fx;
    a.fy[j] = fy;
    a.dyn_v_out[j] = act ? v_new : dyn_v;
    a.i_out[j] = i_step + (act ? 1 : 0);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) buf[lane * kLd + c] = act ? moved[c] : s[c];
#pragma unroll
  for (int c = 0; c < 5; ++c) kbuf[lane * 5 + c] = act ? k[c] : kc[c];
  pbuf[2 * lane] = act ? px : s[0];
  pbuf[2 * lane + 1] = act ? -py : s[1];
  __syncwarp();
  warp_store<8>(a.s_out + static_cast<size_t>(r0) * 8, buf, rows, lane);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 7; ++c) buf[lane * kLd + c] = act ? latents[c] : x[c];
  __syncwarp();
  warp_store<7>(a.dyn_x_out + static_cast<size_t>(r0) * 7, buf, rows, lane);

  // the gains rows: columns 0-4 the new gains, the others copied
  const int g = a.gains;
  const float inv_g = __frcp_rn(static_cast<float>(g));
  const float* dg = a.dyn_gains + static_cast<size_t>(r0) * g;
  float* go = a.dyn_gains_out + static_cast<size_t>(r0) * g;
  for (int e = lane; e < rows * g; e += 32) {
    const int r = row_of(e, inv_g);
    const int c = e - r * g;
    go[e] = c < 5 ? kbuf[r * 5 + c] : dg[e];
  }
  // the position ring, copied with its slot (t_glob + 1) % H written
  int slot = (t_glob + 1) % a.hist;
  slot = slot < 0 ? slot + a.hist : slot;
  const int w = 2 * a.hist;
  const float inv_w = __frcp_rn(static_cast<float>(w));
  const float* ph = a.pos_hist + static_cast<size_t>(r0) * w;
  float* po = a.pos_hist_out + static_cast<size_t>(r0) * w;
  for (int e = lane; e < rows * w; e += 32) {
    const int r = row_of(e, inv_w);
    const int c = e - r * w;
    po[e] = c / 2 == slot ? pbuf[2 * r + c % 2] : ph[e];
  }
}

// agent_pre over args->npad rows on `stream` of `device`. Every pointer is
// a contiguous CUDA tensor of the shape its field names (bools 1 byte,
// int32, float32; a per-rider pair column float32 or float64). Returns
// cudaGetLastError() after the launch (0 on success).
template <bool kSpline>
int launch_pre(const PreArgs<kSpline>& a, int device, void* stream) {
  if (a.npad <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n <= 0 || a.n > a.npad || a.q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (a.npad + kThreads - 1) / kThreads;
  agent_pre_kernel<kSpline>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// agent_post over args->n rows (at least one block: it advances t_glob).
template <bool kFreeze>
int launch_post(const PostArgs<kFreeze>& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n < 0 || a.hist <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = a.n > 0 ? (a.n + kThreads - 1) / kThreads : 1;
  agent_post_kernel<kFreeze>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int csf_agent_pre(const csf::AgentPreArgs* args, int device, void* stream) {
  return launch_pre<false>(*args, device, stream);
}

// the spline instance: besides, a ring of at least lookback + 1 slots
int csf_agent_pre_spline(const csf::AgentPreSplineArgs* args, int device,
                         void* stream) {
  if (args->hist < args->lookback + 1 || args->lookback < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pre<true>(*args, device, stream);
}

int csf_agent_post(const csf::AgentPostArgs* args, int device, void* stream) {
  return launch_post<false>(*args, device, stream);
}

int csf_agent_post_twod(const csf::AgentPostTwodArgs* args, int device,
                        void* stream) {
  return launch_post<true>(*args, device, stream);
}

// agent_post_kernel_whipple over args->n rows (at least one block: it
// advances t_glob). Shared memory: the constants, 80 + 5 * deg1 * segs
// floats, and each warp's staging, within the 48 KB a launch takes
// without opting in.
int csf_agent_post_whipple(const csf::AgentPostWhippleArgs* args, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * (80 + 5 * static_cast<size_t>(args->deg1) * args->segs +
                       kWarps * kWarpFloats);
  if (args->n < 0 || args->hist <= 0 || args->gains < 5 ||
      args->deg1 < 1 || args->segs < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = args->n > 0 ? (args->n + kThreads - 1) / kThreads : 1;
  agent_post_kernel_whipple<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
