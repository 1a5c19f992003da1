// Gate micro-ops on circuit statevectors held in shared memory, one warp
// per circuit (or sample): see the note above WarpState.  Every kernel of
// the port (fidelity, state, shift bank, spill forward, spill tile) runs
// its gates through warp_apply and, for the prefix-reuse shift walk,
// ShiftWalk below; the device-memory route of the fidelity and state
// kernels (vqc_fused.cu) runs the same gate passes, strided_apply, over a
// block's state in device memory.
//
// Qubit q is the q-th MOST significant bit of the amplitude index: its pair
// stride is 2^(n-q-1).  Rotation matrices, sign conventions and the
// half-angle follow repro/kernels/vqc_statevector.py (_rot1, _rot2, _h,
// _cswap) exactly; cosf/sinf are the accurate versions (no fast math).
#pragma once

#include <cuda_runtime.h>

namespace vqc {

enum : int { kH = 0, kCSwap = 1, kRX = 2, kRY = 3, kRZ = 4, kRYY = 5, kRZZ = 6, kCRY = 7, kCRZ = 8 };
enum : int { kNoParam = 0, kTheta = 1, kData = 2, kConst = 3 };
// An op-table row: gate, q0, q1, q2, param kind, param index.
constexpr int kOpFields = 6;

// i with a zero bit inserted at position b (Idx: int for a state in shared
// memory, long long for one in device memory).
template <typename Idx>
__device__ __forceinline__ Idx insert0(Idx i, int b) {
  return ((i >> b) << (b + 1)) | (i & ((Idx(1) << b) - 1));
}

// Gate arithmetic of warp_apply and warp_apply_inner.  x0 * y0 + x1 * y1
// with its rounding fixed (x1 * y1 rounded, then fused into x0 * y0), not
// left to the compiler's contraction: every kernel that inlines a gate,
// in whichever library, gives it the same bits, so a spilled sample's
// checkpoints (the forward kernel's boundary advanced by the tile kernel)
// do not depend on where its depth tiles start, and the single sweep and
// the spill pair agree bit for bit.
__device__ __forceinline__ float dot2(float x0, float y0, float x1, float y1) {
  return fmaf(x0, y0, x1 * y1);
}

// One-qubit rotation g (RX, RY, RZ; CRY and CRZ on the control = 1 pair)
// of the amplitude pair (r0 + i m0, r1 + i m1).
__device__ __forceinline__ void rot1(int g, float c, float sn, float& r0, float& m0, float& r1,
                                     float& m1) {
  float nr0, ni0, nr1, ni1;
  if (g == kRY || g == kCRY) {  // [[c,-s],[s,c]] real
    nr0 = dot2(c, r0, -sn, r1); ni0 = dot2(c, m0, -sn, m1);
    nr1 = dot2(sn, r0, c, r1); ni1 = dot2(sn, m0, c, m1);
  } else if (g == kRX) {  // [[c,-is],[-is,c]]
    nr0 = dot2(c, r0, sn, m1); ni0 = dot2(c, m0, -sn, r1);
    nr1 = dot2(c, r1, sn, m0); ni1 = dot2(c, m1, -sn, r0);
  } else {  // RZ: diag(e^{-it/2}, e^{it/2})
    nr0 = dot2(c, r0, sn, m0); ni0 = dot2(c, m0, -sn, r0);
    nr1 = dot2(c, r1, -sn, m1); ni1 = dot2(c, m1, sn, r1);
  }
  r0 = nr0; m0 = ni0; r1 = nr1; m1 = ni1;
}

// RZZ or RYY on the amplitudes 00, 01, 10, 11 of its two qubits.
__device__ __forceinline__ void rot2(int g, float c, float sn, float& r00, float& m00,
                                     float& r01, float& m01, float& r10, float& m10,
                                     float& r11, float& m11) {
  float n00, j00, n01, j01, n10, j10, n11, j11;
  if (g == kRZZ) {  // e^{-it/2} on |00>,|11>; e^{+it/2} on |01>,|10>
    n00 = dot2(c, r00, sn, m00); j00 = dot2(c, m00, -sn, r00);
    n11 = dot2(c, r11, sn, m11); j11 = dot2(c, m11, -sn, r11);
    n01 = dot2(c, r01, -sn, m01); j01 = dot2(c, m01, sn, r01);
    n10 = dot2(c, r10, -sn, m10); j10 = dot2(c, m10, sn, r10);
  } else {  // RYY: couples (00,11) with +i s, (01,10) with -i s
    n00 = dot2(c, r00, -sn, m11); j00 = dot2(c, m00, sn, r11);
    n11 = dot2(c, r11, -sn, m00); j11 = dot2(c, m11, sn, r00);
    n01 = dot2(c, r01, sn, m10); j01 = dot2(c, m01, -sn, r10);
    n10 = dot2(c, r10, sn, m01); j10 = dot2(c, m10, -sn, r01);
  }
  r00 = n00; m00 = j00; r01 = n01; m01 = j01;
  r10 = n10; m10 = j10; r11 = n11; m11 = j11;
}

// ---------------------------------------------------------------------------
// Warp-cooperative micro-ops: one warp owns one circuit's (or sample's)
// state, a contiguous slice [re: dim][im: dim] of shared memory.  Lane l
// takes the amplitude pairs l, l + 32, ... of a gate and the amplitudes l,
// l + 32, ... of a load, copy or inner product, so it touches bank l,
// except in gates on the five least significant bits (pair stride < 32),
// where two or four lanes share a bank.  Every op ends in __syncwarp(), the
// barrier between one gate's writes and the next gate's reads; callers keep
// every lane on every op (the tables are the same for the whole warp).
// The gate arithmetic is rot1 / rot2.  The lane loops run one
// or two times at the widths the training path uses and stay rolled
// (#pragma unroll 1): unrolled, the inlined gate code of the spill tile
// kernel grew 2.6-fold and ran slower.
constexpr unsigned kFullMask = 0xffffffffu;

struct WarpState {
  float* re;
  float* im;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// cos and sin of half the op's angle (delta added when nonzero; no
// inversion: the caller negates sn for g^dagger).
__device__ __forceinline__ void op_angle(const int* op, float cval, const float* theta,
                                         const float* data, float delta, float& c, float& sn) {
  float ang = op[4] == kTheta ? theta[op[5]] : op[4] == kData ? data[op[5]] : cval;
  if (delta != 0.f) ang = ang + delta;
  c = cosf(ang / 2.f);
  sn = sinf(ang / 2.f);
}

__device__ __forceinline__ void warp_zero(WarpState s, int dim, int lane) {
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    s.re[a] = a == 0 ? 1.f : 0.f;
    s.im[a] = 0.f;
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_copy(WarpState dst, WarpState src, int dim, int lane) {
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    dst.re[a] = src.re[a];
    dst.im[a] = src.im[a];
  }
  __syncwarp();
}

// Column b of a [re/im][amp][sample] state in device memory (n samples).
__device__ __forceinline__ void warp_load(WarpState s, const float* src, int dim, long n,
                                          long b, int lane) {
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    s.re[a] = src[a * n + b];
    s.im[a] = src[(dim + a) * n + b];
  }
  __syncwarp();
}

// warp_load's inverse: the warp's state into column b of a [re/im][amp]
// [sample] array.  Lane l writes amplitudes l, l + 32, ..., n samples
// apart.
__device__ __forceinline__ void warp_store(float* dst, WarpState s, int dim, long n, long b,
                                           int lane) {
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    dst[a * n + b] = s.re[a];
    dst[(dim + a) * n + b] = s.im[a];
  }
  __syncwarp();
}

// |<chi|phi>|^2: per-lane partial sums over amplitudes l, l + 32, ..., then
// a butterfly reduction (every lane gets the same value).
__device__ __forceinline__ float warp_inner(WarpState chi, WarpState phi, int dim, int lane) {
  float ip_re = 0.f, ip_im = 0.f;
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    const float cr = chi.re[a], ci = chi.im[a], pr = phi.re[a], pi = phi.im[a];
    ip_re += cr * pr + ci * pi;
    ip_im += cr * pi - ci * pr;
  }
  ip_re = warp_sum(ip_re);
  ip_im = warp_sum(ip_im);
  __syncwarp();
  return ip_re * ip_re + ip_im * ip_im;
}

// Apply one table op with the given cos / sin of its half angle (ignored by
// H and CSWAP) to the state (re, im) of an n-qubit register: this thread's
// amplitude pairs (quads, cswap pairs) first, first + step, ...  No barrier:
// warp_apply (a warp's state in shared memory) ends it with __syncwarp and
// block_apply (a block's state in device memory) with __syncthreads.
template <typename Idx>
__device__ __forceinline__ void strided_apply(const int* op, float c, float sn, float* re,
                                              float* im, int n, Idx first, Idx step) {
  const int g = op[0];
  if (g == kH) {
    const int b = n - op[1] - 1;
    const Idx st = Idx(1) << b;
    const float inv = 0.7071067811865476f;
#pragma unroll 1
    for (Idx i = first; i < (Idx(1) << (n - 1)); i += step) {
      const Idx i0 = insert0(i, b), i1 = i0 | st;
      const float r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      re[i0] = (r0 + r1) * inv;
      re[i1] = (r0 - r1) * inv;
      im[i0] = (m0 + m1) * inv;
      im[i1] = (m0 - m1) * inv;
    }
  } else if (g == kCSwap) {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1, bc = n - op[3] - 1;
#pragma unroll 1
    for (Idx i = first; i < (Idx(1) << (n - 3)); i += step) {
      const Idx base = insert0(insert0(insert0(i, bc), bb), ba) | (Idx(1) << ba);
      const Idx a01 = base | (Idx(1) << bc), a10 = base | (Idx(1) << bb);
      const float r = re[a01], m = im[a01];
      re[a01] = re[a10];
      im[a01] = im[a10];
      re[a10] = r;
      im[a10] = m;
    }
  } else if (g == kRX || g == kRY || g == kRZ) {
    const int b = n - op[1] - 1;
    const Idx st = Idx(1) << b;
#pragma unroll 1
    for (Idx i = first; i < (Idx(1) << (n - 1)); i += step) {
      const Idx i0 = insert0(i, b), i1 = i0 | st;
      float r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      rot1(g, c, sn, r0, m0, r1, m1);
      re[i0] = r0; im[i0] = m0;
      re[i1] = r1; im[i1] = m1;
    }
  } else {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1;
#pragma unroll 1
    for (Idx i = first; i < (Idx(1) << (n - 2)); i += step) {
      const Idx i00 = insert0(insert0(i, bb), ba);
      const Idx i01 = i00 | (Idx(1) << bb), i10 = i00 | (Idx(1) << ba), i11 = i10 | (Idx(1) << bb);
      float r10 = re[i10], r11 = re[i11], m10 = im[i10], m11 = im[i11];
      if (g == kCRY || g == kCRZ) {
        rot1(g, c, sn, r10, m10, r11, m11);
      } else {
        float r00 = re[i00], r01 = re[i01], m00 = im[i00], m01 = im[i01];
        rot2(g, c, sn, r00, m00, r01, m01, r10, m10, r11, m11);
        re[i00] = r00; im[i00] = m00;
        re[i01] = r01; im[i01] = m01;
      }
      re[i10] = r10; im[i10] = m10;
      re[i11] = r11; im[i11] = m11;
    }
  }
}

// The warp's state in shared memory: lane l takes pairs l, l + 32, ...
__device__ __forceinline__ void warp_apply(const int* op, float c, float sn, WarpState s, int n,
                                           int lane) {
  strided_apply<int>(op, c, sn, s.re, s.im, n, lane, 32);
  __syncwarp();
}

// |<chi|G s>|^2 for a rotation G, given the cos / sin of its half angle,
// without storing G s: a one-gate variant replay fused into its inner
// product (no copy of the checkpoint, no store, one pass).  Each lane sums
// over its own pairs (quads), then a butterfly reduction.
__device__ __forceinline__ void accumulate(float cr, float ci, float r, float m, float& ip_re,
                                           float& ip_im) {
  ip_re += cr * r + ci * m;
  ip_im += cr * m - ci * r;
}

__device__ __forceinline__ float warp_apply_inner(const int* op, float c, float sn, WarpState s,
                                                  WarpState chi, int n, int lane) {
  const int g = op[0];
  float ip_re = 0.f, ip_im = 0.f;
  if (g == kRX || g == kRY || g == kRZ) {
    const int b = n - op[1] - 1, st = 1 << b;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 1)); i += 32) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      float r0 = s.re[i0], r1 = s.re[i1], m0 = s.im[i0], m1 = s.im[i1];
      rot1(g, c, sn, r0, m0, r1, m1);
      accumulate(chi.re[i0], chi.im[i0], r0, m0, ip_re, ip_im);
      accumulate(chi.re[i1], chi.im[i1], r1, m1, ip_re, ip_im);
    }
  } else {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 2)); i += 32) {
      const int i00 = insert0(insert0(i, bb), ba);
      const int i01 = i00 | (1 << bb), i10 = i00 | (1 << ba), i11 = i10 | (1 << bb);
      float r00 = s.re[i00], r01 = s.re[i01], m00 = s.im[i00], m01 = s.im[i01];
      float r10 = s.re[i10], r11 = s.re[i11], m10 = s.im[i10], m11 = s.im[i11];
      if (g == kCRY || g == kCRZ) {
        rot1(g, c, sn, r10, m10, r11, m11);
      } else {
        rot2(g, c, sn, r00, m00, r01, m01, r10, m10, r11, m11);
      }
      accumulate(chi.re[i00], chi.im[i00], r00, m00, ip_re, ip_im);
      accumulate(chi.re[i01], chi.im[i01], r01, m01, ip_re, ip_im);
      accumulate(chi.re[i10], chi.im[i10], r10, m10, ip_re, ip_im);
      accumulate(chi.re[i11], chi.im[i11], r11, m11, ip_re, ip_im);
    }
  }
  ip_re = warp_sum(ip_re);
  ip_im = warp_sum(ip_im);
  __syncwarp();
  return ip_re * ip_re + ip_im * ip_im;
}

// Ops [0, n_ops) of a table applied to the warp's state s.  The op
// angles are computed 32 at a time, lane k taking op k0 + k, and broadcast
// with __shfl_sync; before(k) runs on every lane just before op k (a
// checkpoint or boundary store; it ends in __syncwarp like every op).
struct NoHook {
  __device__ void operator()(int) const {}
};

template <typename Before = NoHook>
__device__ __forceinline__ void warp_evolve(const int* ops, const float* consts, int n_ops,
                                            const float* th, const float* dt, WarpState s, int n,
                                            int lane, Before before = Before()) {
  for (int k0 = 0; k0 < n_ops; k0 += 32) {
    float my_c = 0.f, my_s = 0.f;
    if (k0 + lane < n_ops) {
      op_angle(ops + (k0 + lane) * kOpFields, consts[k0 + lane], th, dt, 0.f, my_c, my_s);
    }
    const int kn = min(32, n_ops - k0);
    for (int j = 0; j < kn; ++j) {
      const float cj = __shfl_sync(kFullMask, my_c, j), sj = __shfl_sync(kFullMask, my_s, j);
      before(k0 + j);
      warp_apply(ops + (k0 + j) * kOpFields, cj, sj, s, n, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The prefix-reuse shift walk, shared by the single-sweep kernel
// (vqc_shiftbank.cu) and the spill tile kernel (vqc_spill.cu).  The plan
// arrives as tables (_WalkTable in vqc_statevector.py):
//   ints:   data ops, train ops (kOpFields each); per train op the tile
//           whose boundary is the state just before it (-1: none); per
//           train op its checkpoint slot (-1: none); the variants as (row,
//           param, first, last, anchor) in descending anchor order | the
//           tiles deepest first as (lo, hi, last checkpoint, tile); the
//           output rows that take the base fidelity;
//   floats: data-op and train-op constant angles, one shift per variant.
// Everything before the '|' and every float is staged in shared memory
// once per block: every step of the walk reads the tables, and from
// shared memory that is a shared-memory load on the step's path instead of
// a round trip to L2.
constexpr int kVarFields = 5;   // a variant row: output row, param, first, last, anchor
constexpr int kTileFields = 4;  // a tile row: lo, hi, last checkpoint, tile index

struct WalkTables {
  const int* data_ops;
  const int* train_ops;
  const int* bnd_of;
  const int* ckpt;
  const int* var;
  const float* data_consts;
  const float* train_consts;
  const float* shifts;

  __device__ WalkTables(const int* itab, const float* ftab, int n_data_ops, int n_train_ops)
      : data_ops(itab),
        train_ops(itab + n_data_ops * kOpFields),
        bnd_of(train_ops + n_train_ops * kOpFields),
        ckpt(bnd_of + n_train_ops),
        var(ckpt + n_train_ops),
        data_consts(ftab),
        train_consts(ftab + n_data_ops),
        shifts(ftab + n_data_ops + n_train_ops) {}

  __device__ static int staged_ints(int n_data_ops, int n_train_ops, int n_variants) {
    return (n_data_ops + n_train_ops) * kOpFields + 2 * n_train_ops + n_variants * kVarFields;
  }
};

// Stage the tables into the front of dynamic shared memory behind the
// block's only barrier (so it comes before any warp leaves); returns the
// staged tables and, through states, where the per-sample states begin
// (rounded up to 32 words, so they start on bank 0: walk_table_bytes in
// vqc_statevector.py).
__device__ __forceinline__ WalkTables stage_tables(float* smem, const int* itab,
                                                   const float* ftab, int n_data_ops,
                                                   int n_train_ops, int n_variants,
                                                   float*& states) {
  const int n_ints = WalkTables::staged_ints(n_data_ops, n_train_ops, n_variants);
  const int n_floats = n_data_ops + n_train_ops + n_variants;
  int* itab_s = reinterpret_cast<int*>(smem);
  float* ftab_s = smem + n_ints;
  for (int i = threadIdx.x; i < n_ints; i += blockDim.x) itab_s[i] = itab[i];
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) ftab_s[i] = ftab[i];
  __syncthreads();
  states = smem + ((n_ints + n_floats + 31) & ~31);
  return WalkTables(itab_s, ftab_s, n_data_ops, n_train_ops);
}

// One sample's walk state: its warp's slots in shared memory (slot k of
// warp w at (k * warps + w) * 2 * 2^m floats past the tables, so lane l
// touches bank l; 0 the running state, 1 chi, 2 one variant, 3 + j
// checkpoint j) and, in registers, the base cos/sin of train ops lane
// and lane + 32 and the shifted cos/sin of variants lane and lane + 32
// (theta[j] + shift: the angle of every gate of parameter j in that
// variant's replay), broadcast with __shfl_sync where they apply; ops and
// variants past the 64th compute theirs where they apply.  The walk is a
// chain of dependent steps at a few warps a scheduler, so each step
// reads only shared memory and registers.
struct ShiftWalk {
  WalkTables tab;
  const float* th;
  const float* dt;
  float* states;
  int warps, warp, lane, m, dim, n_variants;
  float c_lo = 0.f, s_lo = 0.f, c_hi = 0.f, s_hi = 0.f;
  float vc_lo = 0.f, vs_lo = 0.f, vc_hi = 0.f, vs_hi = 0.f;

  __device__ ShiftWalk(const WalkTables& t, const float* theta, const float* data, float* st,
                       int warps_, int warp_, int lane_, int m_, int n_train_ops, int n_var)
      : tab(t), th(theta), dt(data), states(st), warps(warps_), warp(warp_), lane(lane_), m(m_),
        dim(1 << m_), n_variants(n_var) {
    if (lane < n_train_ops) {
      op_angle(tab.train_ops + lane * kOpFields, tab.train_consts[lane], th, dt, 0.f, c_lo, s_lo);
    }
    if (lane + 32 < n_train_ops) {
      op_angle(tab.train_ops + (lane + 32) * kOpFields, tab.train_consts[lane + 32], th, dt, 0.f,
               c_hi, s_hi);
    }
    if (lane < n_variants) {
      const float ang = th[tab.var[lane * kVarFields + 1]] + tab.shifts[lane];
      vc_lo = cosf(ang / 2.f);
      vs_lo = sinf(ang / 2.f);
    }
    if (lane + 32 < n_variants) {
      const float ang = th[tab.var[(lane + 32) * kVarFields + 1]] + tab.shifts[lane + 32];
      vc_hi = cosf(ang / 2.f);
      vs_hi = sinf(ang / 2.f);
    }
  }

  __device__ WarpState slot(int k) const {
    float* base = states + (static_cast<long>(k) * warps + warp) * 2 * dim;
    return WarpState{base, base + dim};
  }

  // k is the same on every lane
  __device__ void base_angle(int k, float& c, float& sn) const {
    if (k < 64) {
      c = __shfl_sync(kFullMask, k < 32 ? c_lo : c_hi, k & 31);
      sn = __shfl_sync(kFullMask, k < 32 ? s_lo : s_hi, k & 31);
    } else {
      op_angle(tab.train_ops + k * kOpFields, tab.train_consts[k], th, dt, 0.f, c, sn);
    }
  }

  __device__ void shifted_angle(int vi, const int* op, float cval, float& c, float& sn) const {
    if (vi < 64) {
      c = __shfl_sync(kFullMask, vi < 32 ? vc_lo : vc_hi, vi & 31);
      sn = __shfl_sync(kFullMask, vi < 32 ? vs_lo : vs_hi, vi & 31);
    } else {
      op_angle(op, cval, th, dt, tab.shifts[vi], c, sn);
    }
  }

  // Train ops [lo, end) on run with base angles, each preceded by the
  // copy into its checkpoint slot where it has one.
  __device__ void advance(WarpState run, int lo, int end) const {
    for (int k = lo; k < end; ++k) {
      checkpoint(run, k);
      float c, sn;
      base_angle(k, c, sn);
      warp_apply(tab.train_ops + k * kOpFields, c, sn, run, m, lane);
    }
  }

  __device__ void checkpoint(WarpState run, int k) const {
    if (tab.ckpt[k] >= 0) warp_copy(slot(3 + tab.ckpt[k]), run, dim, lane);
  }

  // chi walked from hi - 1 down to lo through the inverted train ops
  // (g(t)^dagger = g(-t): cos even, sin odd); at each op every variant
  // anchored there (from vi on) replays its parameter's [first, last] span
  // from its checkpoint, the shift on that parameter's gates, and row
  // |<chi|v>|^2 is written.  chi passes op lo only if further walks follow
  // (past_lo).
  __device__ void walk(int hi, int lo, bool past_lo, int& vi, float* out, long n, long b) const {
    const WarpState chi = slot(1), v = slot(2);
    for (int k = hi - 1; k >= lo; --k) {
      for (; vi < n_variants && tab.var[vi * kVarFields + 4] == k; ++vi) {
        const int* vr = tab.var + vi * kVarFields;
        const int row = vr[0], j = vr[1], first = vr[2], vlast = vr[3];
        float f;
        if (first == vlast) {  // one gate, parameter j's: fused with the inner product
          const int* op = tab.train_ops + first * kOpFields;
          float c, sn;
          shifted_angle(vi, op, tab.train_consts[first], c, sn);
          f = warp_apply_inner(op, c, sn, slot(3 + tab.ckpt[first]), chi, m, lane);
        } else {
          warp_copy(v, slot(3 + tab.ckpt[first]), dim, lane);
          for (int kk = first; kk <= vlast; ++kk) {
            const int* op = tab.train_ops + kk * kOpFields;
            float c, sn;
            if (op[4] == kTheta && op[5] == j && tab.shifts[vi] != 0.f) {
              shifted_angle(vi, op, tab.train_consts[kk], c, sn);
            } else {
              base_angle(kk, c, sn);
            }
            warp_apply(op, c, sn, v, m, lane);
          }
          f = warp_inner(chi, v, dim, lane);
        }
        if (lane == 0) out[row * n + b] = f;
      }
      if (k > lo || past_lo) {
        float c, sn;
        base_angle(k, c, sn);
        warp_apply(tab.train_ops + k * kOpFields, c, -sn, chi, m, lane);
      }
    }
  }
};

// Let a block use more than 48 KB of dynamic shared memory.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace vqc

extern "C" const char* vqc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
