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
// (pair_math.cuh; the cone loop below calls its two halves,
// csf::decision_frame and csf::twod_rest, apart), the thread groups'
// shared pieces are in pair_groups.cuh.
//
// What bounds it. At the main path's configuration (100k agents,
// block_src = 64, kb = 19-24) a call walks 8.8e7-8.9e7 pairs, of which
// ~18% lie within the cutoff (the cells are unscreened: every walked pair
// is summed, as the plain version and JAX sum it); the bytes are small (a
// 4 KB source tile per slot, read from L2). A twod pair with the FOV cone
// needs 72 FP32 operations and at least 5 MUFU (special function unit)
// operations: on an H100 (132 SMs at 1.98 GHz, 128 FP32 lanes and 16
// MUFU results per clock per SM) 0.094 ms of FP32 and 0.105 ms of MUFU
// for 8.8e7 pairs. Walking every pair as compiled (5 MUFU and ~66
// instructions in all, one warp instruction per clock per SM
// sub-partition) is 0.17 ms of issue, so instruction issue bounds the
// kernel. A legacy row (bicycle2d's default field, cutoff ~100 m, kb ~35,
// ~2x the pairs) takes 2 MUFU and ~40 FP32 operations. The work is a
// dependent chain of FP32 and MUFU operations per pair with no matrix
// product in it, so the tensor cores do not apply.
//
// The work that is exactly zero. With the FOV cone (every cell: hfov
// 2 pi / 3), a pair outside its receiver's cone gets the weight 0 and adds
// exactly +-0: two thirds of the walked pairs. A receiver's cone holds
// a whole tile or misses it, but its neighbours face other ways, so a warp
// of receivers almost always needs every source row: the parent's mapping
// (receivers on the lanes) could not skip them. Hence two loops.
//
// The cone loop (the FOV forms without `mixed`: uniform or per-row
// parameters, priority to the right or not, screened or not). The block's
// receivers are staged once in shared memory; a warp owns 64 of them. In
// round t group g's tile holds slot t kGroups + g, as in the walking loop,
// and the round's tiles are walked in chunks of 64 source rows, two per
// lane (two independent chains), a lane's rows read into registers. Per
// chunk:
// - The chunk test. The warp bounds the chunk's rows by a disk (their
//   bounding box's circumcircle) and tests each of its receivers' cones
//   against it (chunk_voters); the voters are the receivers whose cone
//   can hold a row, with margins well above either test's rounding (see
//   cone_meets), every active one where a row or the receiver is not
//   finite or far. ~55% of receiver-chunks vote on the cells, against
//   ~50% that hold a tracked pair: no MUFU and a few instructions a
//   receiver, where deciding every pair took ~15 a pair.
// - The deal. The chunk's voters of every group's tile, in (group,
//   receiver) order, go to all the CTA's warps in contiguous even shares
//   (through shared memory and a CTA barrier a chunk), so no warp and no
//   group waits for another's tile: a tile's cost follows the cones, and
//   statically the eight groups of a CTA ended up to 30% apart.
// - The vote. For each voter, warp-uniform, every lane decides its two
//   pairs with the decision chain (below, the plain version's rounding),
//   and the warp votes (__any_sync) on each unit of 32 rows: the smooth
//   rest of the field (4 of the 5 MUFU, ~50 of the ~66 instructions) runs
//   only where some pair of the unit needs evaluating. A pair needs it
//   where its contribution can be other than +-0: it is tracked, or an
//   input the field multiplies by the zero weight is not finite (its
//   rho2, the source's heading columns, in the per-row form its field
//   columns, the receiver's heading), so a rider that is not finite makes
//   exactly the receivers non-finite that it makes so in the plain
//   version. An inactive receiver never votes (its sum is 0).
// - The sum. The warp's sum for the voter (a fixed shuffle tree) is added
//   to the partial sum, in shared memory, of the group whose tile it is.
// Per 32 walked pairs on the cells that is ~10 warp instructions of
// deciding (55% of the receiver-chunks) and ~25 of smooth rest and sums
// (the 45% of units kept, `pair_field_pct`), against ~66 walking every
// pair. Units of W = 32 rows keep 45% of the walked pairs, of 64 (both
// rows of a lane) 50%, and measured 2% slower on the card (PERF.md); 16
// would split a warp's vote across two receivers, no longer warp-uniform.
//
// The walking loop (the forms without the cone, where every pair with
// rho2 > 0 is tracked and nothing can be skipped, and the mixed
// two-family form), as before: a group's threads hold the block's
// receivers, kRecv = 2 per thread as independent chains fed by one
// broadcast read of each source row, and add every pair.
//
// Shared by both:
// - Instructions per pair. The decision chain of the field (pair_math.cuh)
//   keeps the plain version's rounding; the smooth rest uses explicit
//   fmaf, the MUFU's approximate rsqrt and ex2 with no subnormal guards,
//   and one rsqrt for the exponent's sqrt(rho2 ec2) / sigma (5 MUFU per
//   twod pair, not 6). The tracked mask stays a predicate and the uniform
//   constants are prepared once per thread.
// - The CTA (csf::Cta). A receiver block of kBlock agents (64, 128 or 256,
//   a template parameter) is one CTA of kGroups groups of kBlock / kRecv
//   threads, and group g takes table slots g, g + kGroups, ... for all
//   kBlock receivers. The CTAs are short enough (~2-3 slots per group on
//   the main path) that the SMs stay evenly loaded to the end of the call.
// - Staging. Each group copies its slot's [block_src, 16] tile into its
//   own shared memory with cp.async and, in the walking loop, synchronises
//   on its own named barrier, so the groups never wait for each other;
//   while one group waits for its copy, the others compute (the cone
//   loop waits for a round's tiles at a CTA barrier, as it deals them). A second tile per group (a
//   2-stage ring, the next copy under the current math) measured no
//   faster at block_src 64 and slower at 128, where its shared memory
//   halves the CTAs per SM.
// - Determinism. The groups' partial sums are added in group order at the
//   end, and each receiver's sum inside a group in a fixed order: no
//   atomics on a force, the same result every run. The order differs
//   from the plain version's, so the forces agree with it to the kernels'
//   bar (atol 1e-4, rtol 2e-4), not bit for bit.
// - The count. With `field_pairs` the CTA adds the pairs whose field it
//   evaluated (the kept units' rows; every walked pair in the walking
//   loop) to a device counter: one integer atomicAdd per CTA, after the
//   warps' counts meet in shared memory, so the total is the same every
//   run (ops/pair_forces.field_pairs_ref is its plain version).
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
// (csf::group_in_range). The cone loop takes the votes of a tile's strips
// first and treats the rows of a skipped strip as absent.

#include <cuda_runtime.h>

#include <cfloat>

#include "pair_groups.cuh"
#include "pair_math.cuh"

namespace {

using csf::Cta;
using csf::kRecv;
using csf::kSrcCols;

// The cone loop's shape: a warp holds kWarpRecv receivers of the block
// (every group is kBlock / 64 warps), walks the tile in chunks of kChunk
// source rows, two per lane, and votes on units of 32 rows (a lane's
// first or second row; ops/pair_forces.FIELD_UNIT).
constexpr int kWarpRecv = 64;
constexpr int kChunk = 64;

// A coordinate at or beyond kFar, or not finite, takes its rider out of
// the chunk test (its squares of differences could leave the floats).
constexpr float kFar = 1e18f;

// what a receiver's pairs need in the cone loop (its mode in shared memory)
enum : int {
  kRecvSkip = 0,   // inactive: its sum is 0, nothing is evaluated
  kRecvVote = 1,   // its pairs vote where the chunk test admits it
  kRecvOpen = 2,   // a position far or not finite: its pairs always vote
  kRecvAll = 3,    // a heading not finite: every pair is evaluated
};

// dynamic shared memory of a launch: each group's tile, then the groups'
// partial sums [kGroups][2][kBlock], then (cone loop) the receivers'
// positions and headings [kBlock] float4 and their modes [kBlock] int
template <int kBlock>
size_t shared_bytes(int block_src, bool cone) {
  constexpr int kGroups = Cta<kBlock>::kGroups;
  return sizeof(float) * (kGroups * kSrcCols * (size_t)block_src +
                          kGroups * 2 * kBlock) +
         (cone ? kBlock * (sizeof(float4) + sizeof(int)) : 0);
}

// One source row as a lane of the cone loop holds it. An absent row (past
// the tile, or in a screened strip) is a silent stand-in that the cone
// never holds (neg_chf -2). A pair needs evaluating where it is tracked or
// !(rho2 <= lim): lim is the largest float (rho2 not finite) or, where a
// column the field multiplies by a pair's weight is not finite, -inf
// (every pair). `wide`: a valid row that the chunk test cannot bound (a
// column not finite or a position far).
struct LaneRow {
  csf::SrcRow s;
  csf::FieldConsts q;
  float lim;
  bool valid, wide;
};

template <bool kUniform>
__device__ __forceinline__ LaneRow lane_row(const float4* tile, int j,
                                            bool valid,
                                            const csf::FieldConsts& p) {
  LaneRow l;
  if (valid) {
    l.s = csf::load_row<kUniform, false>(tile + j * 4);
  } else {
    l.s.a = make_float4(0.0f, 0.0f, 1.0f, 0.0f);
    l.s.b = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    l.s.c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    l.s.fam = 0.0f;
  }
  l.q = csf::row_consts<kUniform>(l.s, p);
  bool fin = isfinite(l.s.a.z) && isfinite(l.s.a.w);
  if constexpr (!kUniform) {
    fin = fin && isfinite(l.s.b.y) && isfinite(l.s.b.z) &&
          isfinite(l.s.b.w) && isfinite(l.s.c.x) && isfinite(l.s.c.y) &&
          isfinite(l.s.c.z);
  }
  if (!valid) l.q.neg_chf = -2.0f;
  l.lim = fin ? FLT_MAX : -INFINITY;
  l.valid = valid;
  l.wide = valid && !(fin && fabsf(l.s.a.x) < kFar && fabsf(l.s.a.y) < kFar);
  return l;
}

// the 64-bit ballot of a warp's two flags: bit i of lane i's `a`, bit 32 + i
// of its `b`
__device__ __forceinline__ unsigned long long ballot64(bool a, bool b) {
  return static_cast<unsigned long long>(__ballot_sync(0xffffffffu, a)) |
         static_cast<unsigned long long>(__ballot_sync(0xffffffffu, b))
             << 32;
}

// bits [lo, lo + n) of a chunk's 64 rows, clipped to the chunk
__device__ __forceinline__ unsigned long long run_bits(int lo, int n) {
  const int a = max(lo, 0), e = min(lo + n, kChunk);
  if (e <= a) return 0ull;
  const unsigned long long below_e = e == 64 ? ~0ull : (1ull << e) - 1ull;
  return below_e & ~((1ull << a) - 1ull);
}

// The chunk test. The chunk's valid rows lie in a disk (centre cx, cy;
// radius rad); a receiver at distance d > rad from its centre sees it
// under a half-angle asin(rad / d), so a source in the disk can lie in
// the receiver's cone (u.h >= cos(hfov / 2) for the unit direction u to
// the source and the heading h) only if D.h >= sqrt(d^2 - rad^2) chf -
// rad sqrt(|h|^2 - chf^2) for D the direction to the centre, chf > 0 the
// least cos(hfov / 2) of the rows. The test rejects a receiver only there,
// with the cone widened by 1e-3 in cos(hfov / 2) and the radius by 0.1%:
// margins of ~5e-4 d |h| against float32 roundings of ~1e-5 d |h| in this
// test and ~1e-6 |h| in the decision chain's cone comparison, so it never
// drops a pair that the decision chain tracks. Any NaN admits.
struct ChunkDisk {
  float cx, cy, rad, chf;
};

template <bool kUniform>
__device__ __forceinline__ ChunkDisk chunk_disk(const LaneRow& la,
                                                const LaneRow& lb,
                                                const csf::FieldConsts& p) {
  float xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
  float chf = kUniform ? -p.neg_chf : INFINITY;
  auto take = [&](const LaneRow& l) {
    if (!l.valid) return;
    xlo = fminf(xlo, l.s.a.x);
    xhi = fmaxf(xhi, l.s.a.x);
    ylo = fminf(ylo, l.s.a.y);
    yhi = fmaxf(yhi, l.s.a.y);
    if constexpr (!kUniform) chf = fminf(chf, -l.q.neg_chf);
  };
  take(la);
  take(lb);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
    if constexpr (!kUniform) {
      chf = fminf(chf, __shfl_xor_sync(0xffffffffu, chf, o));
    }
  }
  ChunkDisk d;
  d.cx = 0.5f * (xlo + xhi);
  d.cy = 0.5f * (ylo + yhi);
  const float w = xhi - xlo, h = yhi - ylo;
  d.rad = 0.5005f * sqrtf(w * w + h * h) +
          1e-6f * (fabsf(d.cx) + fabsf(d.cy) + 1.0f);
  d.chf = chf - 1e-3f;
  return d;
}

__device__ __forceinline__ bool cone_meets(const float4 r, const ChunkDisk& d) {
  const float dx = d.cx - r.x, dy = d.cy - r.y;
  const float d2 = dx * dx + dy * dy, rad2 = d.rad * d.rad;
  const float dot = dx * r.z + dy * r.w;
  const float h2 = r.z * r.z + r.w * r.w;
  const float bound = sqrtf(fmaxf(d2 - rad2, 0.0f)) * d.chf -
                      d.rad * sqrtf(fmaxf(h2 - d.chf * d.chf, 0.0f));
  return !(d2 > rad2 && dot < bound);
}

// The warp's receivers whose pairs with the chunk's rows vote (bit i:
// receiver r0 + i): the active ones that the chunk test admits, or all
// active ones where a row is `wide` or the cone is not narrower than a
// half-plane. `rsh`, `rmode` are the warp's receivers.
template <bool kUniform>
__device__ __forceinline__ unsigned long long chunk_voters(
    const LaneRow& la, const LaneRow& lb, const csf::FieldConsts& p,
    const float4* rsh, const int* rmode, int lane) {
  const ChunkDisk d = chunk_disk<kUniform>(la, lb, p);
  const bool wide = __any_sync(0xffffffffu, la.wide || lb.wide) ||
                    !(d.chf > 0.0f);
  const int ma = rmode[lane], mb = rmode[32 + lane];
  bool va = ma != kRecvSkip, vb = mb != kRecvSkip;
  if (!wide) {
    va = va && (ma != kRecvVote || cone_meets(rsh[lane], d));
    vb = vb && (mb != kRecvVote || cone_meets(rsh[32 + lane], d));
  }
  return ballot64(va, vb);
}

// The decision frame of lane row `l` at receiver `r`, and whether the pair
// needs evaluating: its contribution can be other than +-0 (tracked, or an
// input that the field multiplies by the zero weight is not finite: rho2,
// the row's columns; a receiver whose heading is not finite is the
// caller's, kRecvAll).
template <bool kP2R>
__device__ __forceinline__ csf::DecisionFrame decide(const LaneRow& l,
                                                     const csf::Receiver& r,
                                                     bool& need) {
  const csf::DecisionFrame f =
      csf::decision_frame<true, kP2R>(l.s.a.x, l.s.a.y, r, l.q.neg_chf);
  need = f.tracked || !(f.rho2 <= l.lim);
  return f;
}

// (fx, fy) of this warp's lanes summed in a fixed order: lane 0 returns
// the sum of fx, lane 16 that of fy
__device__ __forceinline__ float warp_sum2(float fx, float fy, int lane) {
  float keep = lane < 16 ? fx : fy;
  keep += __shfl_xor_sync(0xffffffffu, lane < 16 ? fy : fx, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    keep += __shfl_xor_sync(0xffffffffu, keep, o);
  }
  return keep;
}

// The cone loop of a CTA over its table slots, in rounds: in round t
// group g's tile holds slot t kGroups + g, as in the walking loop. For each
// chunk of kChunk rows of the round's tiles (two per lane) each warp finds
// the voters among its group's tile and its kWarpRecv receivers
// (chunk_voters); the round's voters of every group, in (group, receiver)
// order, go to the CTA's warps in contiguous even shares, so no warp waits
// for another's tile. For each voter a warp decides its lanes' pairs of
// that tile, votes per unit of 32 rows, runs the smooth rest only for
// the units that some pair needs, and adds its sum for the receiver to
// the tile's group's partial sums `part` (each pair of a group's receiver
// sum and chunk is one warp's, and the chunks' sums add in slot order).
// `masks` and `admits` hold the voters and screened-in rows of each
// group's chunk, two chunks' worth. Returns the rows of the units the
// warp evaluated.
template <int kBlock, bool kUniform, bool kP2R, bool kScreen, typename Fill>
__device__ __forceinline__ int cone_rounds(
    float4* tiles, int tile_vec, const float4* rsh, const int* rmode,
    unsigned long long (*masks)[Cta<kBlock>::kGroups][kBlock / kWarpRecv],
    unsigned long long (*admits)[Cta<kBlock>::kGroups], float* part, int g,
    int lt, int bar, int n_slots, int block_src, int strip, float cutoff2,
    const csf::FieldConsts& p, const csf::Receiver (&rc)[kRecv], Fill fill) {
  using C = Cta<kBlock>;
  constexpr int kGroups = C::kGroups;
  constexpr int kWarps = C::kGroupThreads / 32;   // warps of a group
  constexpr int kCtaWarps = C::kThreads / 32;
  static_assert(kWarps * kWarpRecv == kBlock, "a group holds the block");
  const int lane = lt % 32;
  const int wig = lt / 32;                        // warp in the group
  const int wcta = threadIdx.x / 32;              // warp in the CTA
  float4* const tile = tiles + g * tile_vec;      // this group's tile
  int kept = 0, parity = 0;
  for (int k0 = 0; k0 < n_slots; k0 += kGroups) {
    const bool has = k0 + g < n_slots;            // group-uniform
    csf::cp_async_wait<0>();
    __syncthreads();
    for (int j0 = 0; j0 < block_src; j0 += kChunk) {
      unsigned long long admit = 0ull, mine = 0ull;
      if (has) {
        admit = ~0ull;
        if constexpr (kScreen) {
          admit = 0ull;
          const int end = min(j0 + kChunk, block_src);
          for (int t = j0 - j0 % strip; t < end; t += strip) {
            if (csf::group_in_range<kBlock>(tile, t, strip, lt, rc, cutoff2,
                                             bar)) {
              admit |= run_bits(t - j0, strip);
            }
          }
        }
        const int ja = j0 + lane, jb = ja + 32;
        const bool va = ja < block_src && ((admit >> lane) & 1ull);
        const bool vb = jb < block_src && ((admit >> (lane + 32)) & 1ull);
        if (__any_sync(0xffffffffu, va || vb)) {
          const LaneRow la = lane_row<kUniform>(tile, ja, va, p);
          const LaneRow lb = lane_row<kUniform>(tile, jb, vb, p);
          mine = chunk_voters<kUniform>(la, lb, p, rsh + wig * kWarpRecv,
                                        rmode + wig * kWarpRecv, lane);
        }
      }
      if (lane == 0) masks[parity][g][wig] = mine;
      if (lt == 0) admits[parity][g] = admit;
      __syncthreads();
      // this warp's share of the round's voters: [lo, hi) in (group, warp
      // of the group, receiver) order
      int total = 0;
#pragma unroll
      for (int q = 0; q < kGroups * kWarps; ++q) {
        total += __popcll(masks[parity][q / kWarps][q % kWarps]);
      }
      const int lo = wcta * total / kCtaWarps;
      const int hi = (wcta + 1) * total / kCtaWarps;
      int seen = 0, cur = -1, na = 0, nb = 0;
      LaneRow la, lb;
      for (int q = 0; q < kGroups * kWarps && seen < hi; ++q) {
        const int gg = q / kWarps;
        unsigned long long voters = masks[parity][gg][q % kWarps];
        const int n = __popcll(voters);
        if (seen + n <= lo) {
          seen += n;
          continue;
        }
        for (; seen < lo; ++seen) voters &= voters - 1ull;
        float* const part_x = part + (2 * gg) * kBlock;
        float* const part_y = part_x + kBlock;
        for (; voters != 0ull && seen < hi; ++seen) {
          const int rr = (q % kWarps) * kWarpRecv +
                         __ffsll(static_cast<long long>(voters)) - 1;
          voters &= voters - 1ull;
          if (gg != cur) {
            // the rows of group gg's chunk
            cur = gg;
            const unsigned long long adm = admits[parity][gg];
            const int ja = j0 + lane, jb = ja + 32;
            const bool va = ja < block_src && ((adm >> lane) & 1ull);
            const bool vb = jb < block_src && ((adm >> (lane + 32)) & 1ull);
            na = __popc(__ballot_sync(0xffffffffu, va));
            nb = __popc(__ballot_sync(0xffffffffu, vb));
            const float4* const t = tiles + gg * tile_vec;
            la = lane_row<kUniform>(t, ja, va, p);
            lb = lane_row<kUniform>(t, jb, vb, p);
          }
          const float4 q4 = rsh[rr];
          const csf::Receiver r{q4.x, q4.y, q4.z, q4.w, true};
          bool need_a, need_b;
          const csf::DecisionFrame fa = decide<kP2R>(la, r, need_a);
          const csf::DecisionFrame fb = decide<kP2R>(lb, r, need_b);
          if (rmode[rr] == kRecvAll) {
            need_a = la.valid;
            need_b = lb.valid;
          }
          // a unit is a lane's first or second row: both chains where
          // both units are kept
          float fx = 0.0f, fy = 0.0f;
          const bool keep_a = __any_sync(0xffffffffu, need_a);
          const bool keep_b = __any_sync(0xffffffffu, need_b);
          if (keep_a && keep_b) {
            csf::twod_rest(la.s, r, la.q, fa, fx, fy);
            csf::twod_rest(lb.s, r, lb.q, fb, fx, fy);
            kept += na + nb;
          } else if (keep_a) {
            csf::twod_rest(la.s, r, la.q, fa, fx, fy);
            kept += na;
          } else if (keep_b) {
            csf::twod_rest(lb.s, r, lb.q, fb, fx, fy);
            kept += nb;
          } else {
            continue;
          }
          const float sum = warp_sum2(fx, fy, lane);
          if (lane == 0) part_x[rr] += sum;
          if (lane == 16) part_y[rr] += sum;
        }
      }
      parity ^= 1;
    }
    // the next copies overwrite the tiles only after every warp is done
    // with them
    __syncthreads();
    if (has) fill(k0 + g + kGroups);
  }
  return kept;
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
                        int strip, float cutoff2, csf::TwodParams tp,
                        unsigned long long* __restrict__ field_pairs) {
  using C = Cta<kBlock>;
  constexpr int kGroups = C::kGroups;
  constexpr int kGroupThreads = C::kGroupThreads;
  constexpr bool kCone = kFov && !kMixed;
  extern __shared__ float4 smem4[];
  // the field pairs each warp evaluated
  __shared__ int warp_pairs[C::kThreads / 32];
  // the cone loop's voters of each group's warps, two chunks' worth
  __shared__ unsigned long long voter_masks[kCone ? 2 : 1][kGroups]
                                           [kBlock / kWarpRecv];
  __shared__ unsigned long long chunk_admits[kCone ? 2 : 1][kGroups];

  const int b = blockIdx.x;
  const int g = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int bar = csf::group_barrier(g);
  const int npad = gridDim.x * kBlock;
  const int n_slots = count[b];
  const int tile_vec = block_src * (kSrcCols / 4);
  float4* const tile = smem4 + g * tile_vec;     // this group's tile
  float* const part = reinterpret_cast<float*>(smem4 + kGroups * tile_vec);

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

  if constexpr (kCone) {
    // the block's receivers and what their pairs need, for every warp;
    // the partial sums start at 0
    float4* const rsh = reinterpret_cast<float4*>(part + kGroups * 2 * kBlock);
    int* const rmode = reinterpret_cast<int*>(rsh + kBlock);
    for (int i = threadIdx.x; i < kBlock; i += C::kThreads) {
      const csf::Receiver r = csf::load_receiver(recv, npad, b * kBlock + i);
      rsh[i] = make_float4(r.x, r.y, r.c, r.s);
      const bool near = fabsf(r.x) < kFar && fabsf(r.y) < kFar;
      rmode[i] = !r.act                              ? kRecvSkip
                 : !(isfinite(r.c) && isfinite(r.s)) ? kRecvAll
                 : near                              ? kRecvVote
                                                     : kRecvOpen;
    }
    for (int i = threadIdx.x; i < kGroups * 2 * kBlock; i += C::kThreads) {
      part[i] = 0.0f;
    }
    __syncthreads();
    const int kept = cone_rounds<kBlock, kUniform, kP2R, kScreen>(
        smem4, tile_vec, rsh, rmode, voter_masks, chunk_admits, part, g, lt,
        bar, n_slots, block_src, strip, cutoff2, p, rc, fill);
    if (lt % 32 == 0) warp_pairs[threadIdx.x / 32] = kept;
    __syncthreads();
    csf::add_parts<kBlock>(part, out, npad, b);
  } else {
    int rows = 0;                                // screened-in rows walked
    for (int k = g; k < n_slots; k += kGroups) {
      csf::cp_async_wait<0>();
      csf::group_sync<kGroupThreads>(bar);
      for (int j0 = 0; j0 < block_src; j0 += strip) {
        if constexpr (kScreen) {
          if (!csf::group_in_range<kBlock>(tile, j0, strip, lt, rc, cutoff2,
                                           bar)) {
            continue;
          }
          rows += strip;
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
    // a warp holds 32 kRecv receivers of its group
    if constexpr (kScreen) {
      if (lt % 32 == 0) warp_pairs[threadIdx.x / 32] = rows * 32 * kRecv;
    }
    csf::sum_groups<kBlock>(part, g, lt, rc, fx, fy, out, npad, b);
  }

  // the CTA's count, after the __syncthreads above: one add
  if (field_pairs != nullptr && threadIdx.x == 0) {
    unsigned long long total = 0;
    if constexpr (kCone || kScreen) {
      for (int w = 0; w < C::kThreads / 32; ++w) total += warp_pairs[w];
    } else {
      total = (unsigned long long)n_slots * block_src * kBlock;
    }
    if (total != 0) atomicAdd(field_pairs, total);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of CUDA device `device`. nbr [n_blocks, kb] int32 (the
// first count[b] entries of row b are valid source block indices); src
// [N_src, 16] float32, 16-byte aligned, N_src a multiple of block_src; recv
// [8, n_blocks * block] float32; out [2, n_blocks * block] float32. `block`
// is the receiver block, 64, 128 or 256; block_src must divide it. `strip`
// is the screened source strip (block_src for the tile screen; it must
// divide block_src, at most 32 strips a tile), `cutoff2` the squared cutoff
// the screen compares with; both are ignored without `screen`. e0..chf are
// the shared field parameters (read only with `uniform`); `mixed` selects
// each row's family by its column 13 and excludes `uniform`. `field_pairs`
// (a device uint64, or null) has the pairs whose field the call evaluated
// added to it. Returns cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue, with no launch, for arguments the kernel does not
// take).
int csf_pair_forces_twod(const void* nbr, const void* count,
                         const void* src, const void* recv, void* out,
                         int n_blocks, int kb, int block, int block_src,
                         int uniform, int mixed, int fov, int p2r, int screen,
                         int strip, float cutoff2, float e0, float e1,
                         float s0, float s1, float s2, float s3, float chf,
                         void* field_pairs, int device, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!screen) strip = block_src;
  if (block_src <= 0 || block % block_src != 0 || strip <= 0 ||
      block_src % strip != 0 || block_src / strip > 32 ||
      (uniform && mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const csf::TwodParams p{e0, e1, s0, s1, s2, s3, chf};
  auto s = static_cast<cudaStream_t>(stream);
  const bool known = csf::with_block(block, [&](auto B) {
    constexpr int kBlock = decltype(B)::value;
    // at most 77 KB (block 256, block_src = 256, the cone loop), above the
    // 48 KB a kernel gets unasked
    const size_t smem = shared_bytes<kBlock>(block_src, fov && !mixed);
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
                    kb, block_src, strip, cutoff2, p,
                    static_cast<unsigned long long*>(field_pairs));
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
