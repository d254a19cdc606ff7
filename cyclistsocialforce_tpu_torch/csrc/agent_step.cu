// One step of a bicycle2d engine's per-agent chain, in two kernels around
// the pair kernel (K1, K2 or K3):
//
//   agent_pre   the destination queue update, the navigation FSM and the
//               straight-line destination force, then the pair packs
//               (src [npad, 16], recv [8, npad]) of the twod or the legacy
//               field; an inactive row's FSM fields held at their pre-step
//               values;
//   agent_post  the repulsion clamped to the destination force's magnitude
//               and added to it, bicycle2d's P control and kinematics, and
//               the bookkeeping of the step (inactive rows held, step
//               counters, the position ring).
//
// Replaces the per-agent part of the program that XLA compiles for one
// step of the JAX package's chunk (cyclistsocialforce_tpu/engine.py
// nav_params_view :49-66 and dest_force_straight :73-102, pack_pair_fields
// :901-980, calc_forces' clamp :1118-1151, models/bicycle2d.py step,
// finish_step :1153-1198), which it fuses there; the port ran it as ~330
// PyTorch kernels of ~2 us each.
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

__global__ void __launch_bounds__(kThreads)
    agent_pre_kernel(const AgentPreArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.npad) return;
  float c[kSrcCols];
  if (j >= a.n) {
    // a pad row: inactive at row 0's position with row 0's field columns
    // and zero amplitude (engine.py pack_pair_fields)
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
  auto entry = [&](int p) {
    p = p < 0 ? 0 : (p > a.q - 1 ? a.q - 1 : p);
    return dq + 3 * p;
  };
  auto dist = [&](int p) {
    const float* e = entry(p);
    return norm_rn(__fsub_rn(e[0], x), __fsub_rn(e[1], y));
  };

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
  const int istop = became_stop ? i_step : a.i_stopsignal[j];
  const float dstop = became_stop
                          ? norm_rn(__fsub_rn(d0x, ndx), __fsub_rn(d0y, ndy))
                          : a.d_stopsignal[j];
  // ops/navigation.py dest_distance at the new pointer
  const float ddest = dist(ptr);

  // ops/navigation.py update_nav_state
  const float* zp = a.znavparams + static_cast<size_t>(j) * 4;
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

  // ops/forces.py dest_force_straight
  const bool ok = ddest > 0.0f;
  const float safe = ok ? ddest : 1.0f;
  a.fdx[j] = ok ? __fdiv_rn(__fmul_rn(-vd, __fsub_rn(x, ndx)), safe) : 0.0f;
  a.fdy[j] = ok ? __fdiv_rn(__fmul_rn(-vd, __fsub_rn(y, ndy)), safe) : 0.0f;
  // an inactive row holds its pre-step FSM fields (engine.py finish_step)
  const bool live = a.active[j];
  a.dest_out[3 * j] = live ? ndx : d0x;
  a.dest_out[3 * j + 1] = live ? ndy : d0y;
  a.dest_out[3 * j + 2] = live ? ndz : d0z;
  a.ptr_out[j] = live ? ptr : p0;
  a.znav_out[3 * j] = live ? n0 : z0;
  a.znav_out[3 * j + 1] = live ? n1 : z1;
  a.znav_out[3 * j + 2] = live ? n2 : z2;
  float* zo = a.znavp_out + static_cast<size_t>(j) * 4;
  zo[0] = live ? zn0 : zp[0];
  zo[1] = live ? zn1 : zp[1];
  zo[2] = live ? zn2 : zp[2];
  zo[3] = live ? zn3 : zp[3];
  a.istop_out[j] = live ? istop : a.i_stopsignal[j];
  a.dstop_out[j] = live ? dstop : a.d_stopsignal[j];

  // engine.py pack_pair_fields
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

__global__ void __launch_bounds__(kThreads)
    agent_post_kernel(const AgentPostArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j == 0) a.t_out[0] = a.t_glob[0] + 1;
  if (j >= a.n) return;
  const float inv_two_pi = __fdiv_rn(1.0f, kTwoPi);
  const float* s = a.s + static_cast<size_t>(j) * 8;

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

  // engine.py finish_step: an inactive row holds its pre-step state (its
  // FSM fields, agent_pre's, already do)
  const bool act = a.active[j];
  float* so = a.s_out + static_cast<size_t>(j) * 8;
  const float moved[5] = {nx, ny, psi, v, delta};
  for (int k = 0; k < 8; ++k) so[k] = act && k < 5 ? moved[k] : s[k];
  a.pid_e_out[2 * j] = act ? ddelta : a.pid_e[2 * j];
  a.pid_e_out[2 * j + 1] = act ? dv : a.pid_e[2 * j + 1];
  a.pid_i_out[2 * j] = act ? i0 : a.pid_i[2 * j];
  a.pid_i_out[2 * j + 1] = act ? i1 : a.pid_i[2 * j + 1];
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

}  // namespace

extern "C" {

// agent_pre over args->npad rows on `stream` of `device`. Every pointer is
// a contiguous CUDA tensor of the shape its field names (bools 1 byte,
// int32, float32; a per-rider pair column float32 or float64). Returns
// cudaGetLastError() after the launch (0 on success).
int csf_agent_pre(const csf::AgentPreArgs* args, int device, void* stream) {
  if (args->npad <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->n <= 0 || args->n > args->npad || args->q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (args->npad + kThreads - 1) / kThreads;
  agent_pre_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

// agent_post over args->n rows (at least one block: it advances t_glob).
int csf_agent_post(const csf::AgentPostArgs* args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->n < 0 || args->hist <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = args->n > 0 ? (args->n + kThreads - 1) / kThreads : 1;
  agent_post_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
