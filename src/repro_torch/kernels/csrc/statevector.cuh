// Gate micro-ops on one circuit's statevector held in shared memory.
//
// A state over n qubits is one column of a block-shared array laid out
// [amplitude][circuit]: amplitude a of the thread's circuit sits at
// re[a * tb] and im[a * tb], where tb is the block's circuit count.  Each
// thread touches only its own column, so neighbouring threads hit
// neighbouring words (no bank conflicts) and no barrier is needed.
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

// Apply one table op to the state s of an n-qubit register.  The angle is
// the op's source (theta / data row of this circuit, or the constant),
// plus delta when delta != 0, negated when invert (g(t)^dagger = g(-t));
// H and CSWAP are their own inverses.
__device__ __noinline__ void apply_op(const int* op, float cval, Col s, int n,
                                      const float* theta, const float* data,
                                      float delta, bool invert) {
  const int g = op[0];
  if (g == kH) {
    const int b = n - op[1] - 1, st = 1 << b;
    const float inv = 0.7071067811865476f;
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
    for (int i = 0; i < (1 << (n - 1)); ++i) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      const float r0 = s.r(i0), r1 = s.r(i1), m0 = s.i(i0), m1 = s.i(i1);
      float nr0, ni0, nr1, ni1;
      if (g == kRY) {  // [[c,-s],[s,c]] real
        nr0 = c * r0 - sn * r1; ni0 = c * m0 - sn * m1;
        nr1 = sn * r0 + c * r1; ni1 = sn * m0 + c * m1;
      } else if (g == kRX) {  // [[c,-is],[-is,c]]
        nr0 = c * r0 + sn * m1; ni0 = c * m0 - sn * r1;
        nr1 = c * r1 + sn * m0; ni1 = c * m1 - sn * r0;
      } else {  // RZ: diag(e^{-it/2}, e^{it/2})
        nr0 = c * r0 + sn * m0; ni0 = c * m0 - sn * r0;
        nr1 = c * r1 - sn * m1; ni1 = c * m1 + sn * r1;
      }
      s.r(i0) = nr0; s.i(i0) = ni0;
      s.r(i1) = nr1; s.i(i1) = ni1;
    }
    return;
  }

  // two-qubit rotations on qa < qb (the table swaps descending ryy/rzz and
  // rejects descending cry/crz): bit positions ba > bb.
  const int ba = n - op[1] - 1, bb = n - op[2] - 1;
  for (int i = 0; i < (1 << (n - 2)); ++i) {
    const int i00 = insert0(insert0(i, bb), ba);
    const int i01 = i00 | (1 << bb), i10 = i00 | (1 << ba), i11 = i10 | (1 << bb);
    const float r10 = s.r(i10), r11 = s.r(i11), m10 = s.i(i10), m11 = s.i(i11);
    if (g == kCRY) {  // RY on qb within the qa = 1 block
      s.r(i10) = c * r10 - sn * r11; s.i(i10) = c * m10 - sn * m11;
      s.r(i11) = sn * r10 + c * r11; s.i(i11) = sn * m10 + c * m11;
      continue;
    }
    if (g == kCRZ) {  // RZ on qb within the qa = 1 block
      s.r(i10) = c * r10 + sn * m10; s.i(i10) = c * m10 - sn * r10;
      s.r(i11) = c * r11 - sn * m11; s.i(i11) = c * m11 + sn * r11;
      continue;
    }
    const float r00 = s.r(i00), r01 = s.r(i01), m00 = s.i(i00), m01 = s.i(i01);
    if (g == kRZZ) {  // e^{-it/2} on |00>,|11>; e^{+it/2} on |01>,|10>
      s.r(i00) = c * r00 + sn * m00; s.i(i00) = c * m00 - sn * r00;
      s.r(i11) = c * r11 + sn * m11; s.i(i11) = c * m11 - sn * r11;
      s.r(i01) = c * r01 - sn * m01; s.i(i01) = c * m01 + sn * r01;
      s.r(i10) = c * r10 - sn * m10; s.i(i10) = c * m10 + sn * r10;
    } else {  // RYY: couples (00,11) with +i s, (01,10) with -i s
      s.r(i00) = c * r00 - sn * m11; s.i(i00) = c * m00 + sn * r11;
      s.r(i11) = c * r11 - sn * m00; s.i(i11) = c * m11 + sn * r00;
      s.r(i01) = c * r01 + sn * m10; s.i(i01) = c * m01 - sn * r10;
      s.r(i10) = c * r10 + sn * m01; s.i(i10) = c * m10 - sn * r01;
    }
  }
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
