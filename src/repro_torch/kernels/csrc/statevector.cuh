// Gate micro-ops on circuit statevectors held in shared memory, in two
// layouts.
//
// One thread per circuit (apply_op and the Col helpers; kernels 2, 3 and
// 4): a state over n qubits is one column of a block-shared array laid out
// [amplitude][circuit]: amplitude a of the thread's circuit sits at
// re[a * tb] and im[a * tb], where tb is the block's circuit count.  Each
// thread touches only its own column, so neighbouring threads hit
// neighbouring words (no bank conflicts) and no barrier is needed.
//
// One warp per circuit (warp_apply and the warp_* helpers; kernels 1 and
// 5): see the note above WarpState.
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

struct Col {
  float* re;
  float* im;
  int tb;
  __device__ __forceinline__ float& r(int a) const { return re[a * tb]; }
  __device__ __forceinline__ float& i(int a) const { return im[a * tb]; }
};

// i with a zero bit inserted at position b.
__device__ __forceinline__ int insert0(int i, int b) {
  return ((i >> b) << (b + 1)) | (i & ((1 << b) - 1));
}

__device__ __forceinline__ void zero_state(Col s, int dim) {
  for (int a = 0; a < dim; ++a) {
    s.r(a) = a == 0 ? 1.f : 0.f;
    s.i(a) = 0.f;
  }
}

__device__ __forceinline__ void copy_state(Col dst, Col src, int dim) {
  for (int a = 0; a < dim; ++a) {
    dst.r(a) = src.r(a);
    dst.i(a) = src.i(a);
  }
}

// |<chi|phi>|^2, summed over amplitudes in order.
__device__ __forceinline__ float inner_fidelity(Col chi, Col phi, int dim) {
  float ip_re = 0.f, ip_im = 0.f;
  for (int a = 0; a < dim; ++a) {
    const float cr = chi.r(a), ci = chi.i(a), pr = phi.r(a), pi = phi.i(a);
    ip_re += cr * pr + ci * pi;
    ip_im += cr * pi - ci * pr;
  }
  return ip_re * ip_re + ip_im * ip_im;
}

// Gate arithmetic, shared by apply_op and warp_apply.  x0 * y0 + x1 * y1
// with its rounding fixed (x1 * y1 rounded, then fused into x0 * y0), not
// left to the compiler's contraction: a state reached through apply_op
// (one thread per circuit) and one reached through warp_apply (one warp)
// agree bit for bit, gate by gate, so a spilled sample's checkpoints do not
// depend on where its depth tiles start.
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

// Apply one table op to the state s of an n-qubit register.  The angle is
// the op's source (theta / data row of this circuit, or the constant),
// plus delta when delta != 0, negated when invert (g(t)^dagger = g(-t));
// H and CSWAP are their own inverses.  The pair loops stay rolled
// (#pragma unroll 1): unrolled, the callee's larger register set left
// shift_forward_kernel, at its 64-register cap, spilling 24 B across the
// calls.
__device__ __noinline__ void apply_op(const int* op, float cval, Col s, int n,
                                      const float* theta, const float* data,
                                      float delta, bool invert) {
  const int g = op[0];
  if (g == kH) {
    const int b = n - op[1] - 1, st = 1 << b;
    const float inv = 0.7071067811865476f;
#pragma unroll 1
    for (int i = 0; i < (1 << (n - 1)); ++i) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      const float r0 = s.r(i0), r1 = s.r(i1), m0 = s.i(i0), m1 = s.i(i1);
      s.r(i0) = (r0 + r1) * inv;
      s.r(i1) = (r0 - r1) * inv;
      s.i(i0) = (m0 + m1) * inv;
      s.i(i1) = (m0 - m1) * inv;
    }
    return;
  }
  if (g == kCSwap) {
    // control qa < qb < qc, so bit positions ba > bb > bc; inside the
    // control = 1 block swap the (qb, qc) pair (0,1) <-> (1,0).
    const int ba = n - op[1] - 1, bb = n - op[2] - 1, bc = n - op[3] - 1;
#pragma unroll 1
    for (int i = 0; i < (1 << (n - 3)); ++i) {
      const int base = insert0(insert0(insert0(i, bc), bb), ba) | (1 << ba);
      const int a01 = base | (1 << bc), a10 = base | (1 << bb);
      const float r = s.r(a01), m = s.i(a01);
      s.r(a01) = s.r(a10);
      s.i(a01) = s.i(a10);
      s.r(a10) = r;
      s.i(a10) = m;
    }
    return;
  }
  float ang = op[4] == kTheta ? theta[op[5]] : op[4] == kData ? data[op[5]] : cval;
  if (delta != 0.f) ang = ang + delta;
  if (invert) ang = -ang;
  const float c = cosf(ang / 2.f), sn = sinf(ang / 2.f);

  if (g == kRX || g == kRY || g == kRZ) {
    const int b = n - op[1] - 1, st = 1 << b;
#pragma unroll 1
    for (int i = 0; i < (1 << (n - 1)); ++i) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      float r0 = s.r(i0), r1 = s.r(i1), m0 = s.i(i0), m1 = s.i(i1);
      rot1(g, c, sn, r0, m0, r1, m1);
      s.r(i0) = r0; s.i(i0) = m0;
      s.r(i1) = r1; s.i(i1) = m1;
    }
    return;
  }

  // two-qubit rotations on qa < qb (the table swaps descending ryy/rzz and
  // rejects descending cry/crz): bit positions ba > bb.
  const int ba = n - op[1] - 1, bb = n - op[2] - 1;
#pragma unroll 1
  for (int i = 0; i < (1 << (n - 2)); ++i) {
    const int i00 = insert0(insert0(i, bb), ba);
    const int i01 = i00 | (1 << bb), i10 = i00 | (1 << ba), i11 = i10 | (1 << bb);
    float r10 = s.r(i10), r11 = s.r(i11), m10 = s.i(i10), m11 = s.i(i11);
    if (g == kCRY || g == kCRZ) {  // RY / RZ on qb within the qa = 1 block
      rot1(g, c, sn, r10, m10, r11, m11);
    } else {
      float r00 = s.r(i00), r01 = s.r(i01), m00 = s.i(i00), m01 = s.i(i01);
      rot2(g, c, sn, r00, m00, r01, m01, r10, m10, r11, m11);
      s.r(i00) = r00; s.i(i00) = m00;
      s.r(i01) = r01; s.i(i01) = m01;
    }
    s.r(i10) = r10; s.i(i10) = m10;
    s.r(i11) = r11; s.i(i11) = m11;
  }
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
// The gate arithmetic is apply_op's (rot1, rot2).  The lane loops run one
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

// cos and sin of half the op's angle, as apply_op computes them (delta
// added when nonzero; no inversion: the caller negates sn for g^dagger).
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
// H and CSWAP) to the warp's state of an n-qubit register.
__device__ __forceinline__ void warp_apply(const int* op, float c, float sn, WarpState s, int n,
                                           int lane) {
  const int g = op[0];
  float* re = s.re;
  float* im = s.im;
  if (g == kH) {
    const int b = n - op[1] - 1, st = 1 << b;
    const float inv = 0.7071067811865476f;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 1)); i += 32) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      const float r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      re[i0] = (r0 + r1) * inv;
      re[i1] = (r0 - r1) * inv;
      im[i0] = (m0 + m1) * inv;
      im[i1] = (m0 - m1) * inv;
    }
  } else if (g == kCSwap) {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1, bc = n - op[3] - 1;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 3)); i += 32) {
      const int base = insert0(insert0(insert0(i, bc), bb), ba) | (1 << ba);
      const int a01 = base | (1 << bc), a10 = base | (1 << bb);
      const float r = re[a01], m = im[a01];
      re[a01] = re[a10];
      im[a01] = im[a10];
      re[a10] = r;
      im[a10] = m;
    }
  } else if (g == kRX || g == kRY || g == kRZ) {
    const int b = n - op[1] - 1, st = 1 << b;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 1)); i += 32) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      float r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      rot1(g, c, sn, r0, m0, r1, m1);
      re[i0] = r0; im[i0] = m0;
      re[i1] = r1; im[i1] = m1;
    }
  } else {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1;
#pragma unroll 1
    for (int i = lane; i < (1 << (n - 2)); i += 32) {
      const int i00 = insert0(insert0(i, bb), ba);
      const int i01 = i00 | (1 << bb), i10 = i00 | (1 << ba), i11 = i10 | (1 << bb);
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
