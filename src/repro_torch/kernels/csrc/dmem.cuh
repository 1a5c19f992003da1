// The device-memory route's chunk machinery, shared by the fidelity and
// state kernels' route (vqc_fused.cu) and the shift walk's (vqc_shift_dmem.cu):
// a chunk of 2^k amplitudes of a state held in device memory (its local
// bits varying, the others fixed) staged in a block's shared memory, the
// deposit tables that map a chunk's local index to its amplitude, the
// chunk's loads and stores a float4 at a time through L2, and chunk_gates,
// a pass's gates applied to the staged chunk with the warp kernels'
// arithmetic (rot1, rot2, dot2 of statevector.cuh).
#pragma once

#include "statevector.cuh"

namespace vqc {

constexpr int kDepLo = 256;     // deposit table of local bits 0-7
constexpr int kDepHi = 64;      // of local bits 8-13 (k <= 14)

__device__ __forceinline__ unsigned long long mask_at(const int* row) {
  return static_cast<unsigned>(row[0]) | static_cast<unsigned long long>(static_cast<unsigned>(row[1]))
                                             << 32;
}

// x's bits, lowest first, placed at the set bits of mask, lowest first.
__device__ __forceinline__ long long deposit(long long x, unsigned long long mask) {
  long long out = 0;
  for (int b = 0; mask; ++b, mask >>= 1) {
    if (mask & 1) {
      out |= (x & 1) << b;
      x >>= 1;
    }
  }
  return out;
}

// strided_apply on a chunk seen as 2^n float4 elements (n = k - 2), for a
// gate whose qubits all sit at local bits >= 2: it acts alike on the four
// amplitudes of an element, so each component goes through the gate
// arithmetic of strided_apply (rot1, rot2, the H sums) and a shared load
// moves four amplitudes.
__device__ __forceinline__ float4 h_sum(float4 a, float4 b, float inv) {
  return make_float4((a.x + b.x) * inv, (a.y + b.y) * inv, (a.z + b.z) * inv, (a.w + b.w) * inv);
}

__device__ __forceinline__ float4 h_diff(float4 a, float4 b, float inv) {
  return make_float4((a.x - b.x) * inv, (a.y - b.y) * inv, (a.z - b.z) * inv, (a.w - b.w) * inv);
}

__device__ __forceinline__ void rot1_4(int g, float c, float sn, float4& r0, float4& m0,
                                       float4& r1, float4& m1) {
  rot1(g, c, sn, r0.x, m0.x, r1.x, m1.x);
  rot1(g, c, sn, r0.y, m0.y, r1.y, m1.y);
  rot1(g, c, sn, r0.z, m0.z, r1.z, m1.z);
  rot1(g, c, sn, r0.w, m0.w, r1.w, m1.w);
}

__device__ __forceinline__ void rot2_4(int g, float c, float sn, float4& r00, float4& m00,
                                       float4& r01, float4& m01, float4& r10, float4& m10,
                                       float4& r11, float4& m11) {
  rot2(g, c, sn, r00.x, m00.x, r01.x, m01.x, r10.x, m10.x, r11.x, m11.x);
  rot2(g, c, sn, r00.y, m00.y, r01.y, m01.y, r10.y, m10.y, r11.y, m11.y);
  rot2(g, c, sn, r00.z, m00.z, r01.z, m01.z, r10.z, m10.z, r11.z, m11.z);
  rot2(g, c, sn, r00.w, m00.w, r01.w, m01.w, r10.w, m10.w, r11.w, m11.w);
}

__device__ __forceinline__ void strided_apply4(const int* op, float c, float sn, float4* re,
                                               float4* im, int n, int first, int step) {
  const int g = op[0];
  if (g == kH) {
    const int b = n - op[1] - 1, st = 1 << b;
    const float inv = 0.7071067811865476f;
#pragma unroll 1
    for (int i = first; i < (1 << (n - 1)); i += step) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      const float4 r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      re[i0] = h_sum(r0, r1, inv);
      re[i1] = h_diff(r0, r1, inv);
      im[i0] = h_sum(m0, m1, inv);
      im[i1] = h_diff(m0, m1, inv);
    }
  } else if (g == kCSwap) {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1, bc = n - op[3] - 1;
#pragma unroll 1
    for (int i = first; i < (1 << (n - 3)); i += step) {
      const int base = insert0(insert0(insert0(i, bc), bb), ba) | (1 << ba);
      const int a01 = base | (1 << bc), a10 = base | (1 << bb);
      const float4 r = re[a01], m = im[a01];
      re[a01] = re[a10];
      im[a01] = im[a10];
      re[a10] = r;
      im[a10] = m;
    }
  } else if (g == kRX || g == kRY || g == kRZ) {
    const int b = n - op[1] - 1, st = 1 << b;
#pragma unroll 1
    for (int i = first; i < (1 << (n - 1)); i += step) {
      const int i0 = insert0(i, b), i1 = i0 | st;
      float4 r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
      rot1_4(g, c, sn, r0, m0, r1, m1);
      re[i0] = r0; im[i0] = m0;
      re[i1] = r1; im[i1] = m1;
    }
  } else {
    const int ba = n - op[1] - 1, bb = n - op[2] - 1;
#pragma unroll 1
    for (int i = first; i < (1 << (n - 2)); i += step) {
      const int i00 = insert0(insert0(i, bb), ba);
      const int i01 = i00 | (1 << bb), i10 = i00 | (1 << ba), i11 = i10 | (1 << bb);
      float4 r10 = re[i10], r11 = re[i11], m10 = im[i10], m11 = im[i11];
      if (g == kCRY || g == kCRZ) {
        rot1_4(g, c, sn, r10, m10, r11, m11);
      } else {
        float4 r00 = re[i00], r01 = re[i01], m00 = im[i00], m01 = im[i01];
        rot2_4(g, c, sn, r00, m00, r01, m01, r10, m10, r11, m11);
        re[i00] = r00; im[i00] = m00;
        re[i01] = r01; im[i01] = m01;
      }
      re[i10] = r10; im[i10] = m10;
      re[i11] = r11; im[i11] = m11;
    }
  }
}

// A run of one-qubit rotations, ops [j0, j1), on the same qubit, as
// strided_apply4 would apply them one after another, each element pair
// loaded once: every amplitude meets the same rot1 calls in the same order.
__device__ __forceinline__ void rot1_run4(const int* ops, const float* angles, int j0, int j1,
                                          float4* re, float4* im, int n, int first, int step) {
  const int b = n - ops[j0 * kOpFields + 1] - 1, st = 1 << b;
#pragma unroll 1
  for (int i = first; i < (1 << (n - 1)); i += step) {
    const int i0 = insert0(i, b), i1 = i0 | st;
    float4 r0 = re[i0], r1 = re[i1], m0 = im[i0], m1 = im[i1];
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
      rot1_4(ops[j * kOpFields], angles[2 * j], angles[2 * j + 1], r0, m0, r1, m1);
    }
    re[i0] = r0; im[i0] = m0;
    re[i1] = r1; im[i1] = m1;
  }
}

__device__ __forceinline__ bool is_rot1(int g) { return g == kRX || g == kRY || g == kRZ; }

// H or a one-qubit rotation on the amplitude pair (r0 + i m0, r1 + i m1),
// with strided_apply's arithmetic.
__device__ __forceinline__ void one_qubit(int g, float c, float sn, float& r0, float& m0,
                                          float& r1, float& m1) {
  if (g == kH) {
    const float inv = 0.7071067811865476f;
    const float a = r0, b = m0;
    r0 = (a + r1) * inv;
    r1 = (a - r1) * inv;
    m0 = (b + m1) * inv;
    m1 = (b - m1) * inv;
  } else {
    rot1(g, c, sn, r0, m0, r1, m1);
  }
}

// A run of one-qubit gates (H, RX, RY, RZ), ops [j0, j1), on local bit 0
// or 1, where both pairs of a gate lie inside one float4 (bit 0: (x, y) and
// (z, w); bit 1: (x, z) and (y, w)): each element loaded once, every
// amplitude meeting the same gates in the same order.
__device__ __forceinline__ void low_run4(const int* ops, const float* angles, int j0, int j1,
                                         int bit, float4* re, float4* im, int n4, int first,
                                         int step) {
#pragma unroll 1
  for (int e = first; e < n4; e += step) {
    float4 r = re[e], m = im[e];
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
      const int g = ops[j * kOpFields];
      const float c = angles[2 * j], sn = angles[2 * j + 1];
      if (bit == 0) {
        one_qubit(g, c, sn, r.x, m.x, r.y, m.y);
        one_qubit(g, c, sn, r.z, m.z, r.w, m.w);
      } else {
        one_qubit(g, c, sn, r.x, m.x, r.z, m.z);
        one_qubit(g, c, sn, r.y, m.y, r.w, m.w);
      }
    }
    re[e] = r;
    im[e] = m;
  }
}

// The op's highest local qubit (its qubits are ascending): the gate leaves
// local bits 0 and 1 alone when it is at most k - 3.
__device__ __forceinline__ int top_qubit(const int* op) {
  return op[0] == kCSwap ? op[3] : op[0] >= kRYY ? op[2] : op[1];
}

// Sum over the block (every thread gets it): warp sums, then the warps'
// partials in order.
__device__ __forceinline__ float block_sum(float x, float* partial) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // partial is free
  if (lane == 0) partial[warp] = x;
  __syncthreads();
  x = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
  return warp_sum(x);
}

// A chunk's amplitudes between device memory (through L2: ld.global.cg,
// st.global.cg) and shared memory, a float4 at a time: local bits 0 and 1
// are the index's bits 0 and 1 (every pass keeps the lowest-order qubits
// local), so four local neighbours are four neighbours in device memory
// and share the index's other bits.
struct Chunk {
  long long base;            // the chunk's fixed bits
  const long long* dep_lo;   // amplitude offset of local bits 0-7
  const long long* dep_hi;   // of local bits 8-13
  int size;                  // 2^k amplitudes

  __device__ long long at(int l) const { return base | dep_lo[l & 255] | dep_hi[l >> 8]; }
};

// The chunk into shared memory: |0...0> made there in the first pass, an
// amplitude under the zero mask read as 0.
__device__ __forceinline__ void load_chunk(const Chunk& ch, float4* sre, float4* sim,
                                           const float* re, const float* im,
                                           unsigned long long zero, bool first) {
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    const long long g = ch.at(4 * e);
    float4 r{}, m{};
    if (first) {
      if (g == 0) r.x = 1.f;
    } else if (!(g & zero)) {
      r = __ldcg(reinterpret_cast<const float4*>(re + g));
      m = __ldcg(reinterpret_cast<const float4*>(im + g));
    }
    sre[e] = r;
    sim[e] = m;
  }
}

// The chunk back to device memory (sre == nullptr: zeros).
__device__ __forceinline__ void store_chunk(const Chunk& ch, const float4* sre,
                                            const float4* sim, float* re, float* im) {
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    const long long g = ch.at(4 * e);
    __stcg(reinterpret_cast<float4*>(re + g), sre ? sre[e] : float4{});
    __stcg(reinterpret_cast<float4*>(im + g), sim ? sim[e] : float4{});
  }
}

// Ops [lo, hi) on the chunk in shared memory, a float4 at a time: gates on
// local bits >= 2 through strided_apply4, consecutive one-qubit rotations of
// one such qubit in one sweep, runs of one-qubit gates on local bit 0 or 1
// inside each float4; the rest (two- and three-qubit gates on bit 0 or 1)
// through strided_apply.
__device__ __noinline__ void chunk_gates(const int* ops, const float* angles, int lo, int hi,
                                         float* sre, float* sim, int k) {
  float4* sre4 = reinterpret_cast<float4*>(sre);
  float4* sim4 = reinterpret_cast<float4*>(sim);
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll 1
  for (int j = lo, j1; j < hi; j = j1) {
    const int* op = ops + j * kOpFields;
    j1 = j + 1;
    if (top_qubit(op) > k - 3 && (is_rot1(op[0]) || op[0] == kH)) {
      while (j1 < hi && ops[j1 * kOpFields + 1] == op[1] &&
             (is_rot1(ops[j1 * kOpFields]) || ops[j1 * kOpFields] == kH)) {
        ++j1;
      }
      low_run4(ops, angles, j, j1, k - 1 - op[1], sre4, sim4, 1 << (k - 2), tid, nt);
    } else if (top_qubit(op) > k - 3) {
      strided_apply<int>(op, angles[2 * j], angles[2 * j + 1], sre, sim, k, tid, nt);
    } else if (is_rot1(op[0])) {
      while (j1 < hi && is_rot1(ops[j1 * kOpFields]) && ops[j1 * kOpFields + 1] == op[1]) ++j1;
      rot1_run4(ops, angles, j, j1, sre4, sim4, k - 2, tid, nt);
    } else {
      strided_apply4(op, angles[2 * j], angles[2 * j + 1], sre4, sim4, k - 2, tid, nt);
    }
    __syncthreads();
  }
}

}  // namespace vqc
