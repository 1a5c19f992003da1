// The dense encoding layer's gradient on the two m-qubit registers
// (kernels/dense_grad.py; grad_shift in core/quclassi.py).
//
// QuClassi's dense layer turns each patch into the data angles
// x = pi * sigmoid(patch @ W + b), and the SWAP test reads the fidelity
// F_c = |s_c|^2, s_c = <phi(x)|psi(theta_c)>, of the data register's state
// phi(x) and the trainable register's psi(theta_c).  phi(x) is a product
// state: data qubit q holds f_q = R_q2(x) R_q1(x) |0>, each encoding
// rotation driven by its own angle.  So ds_c/dx_j changes only one qubit's
// two-amplitude factor (dR(a)/da = R(a + pi) / 2), and
//   dF_c/dx_j = 2 Re(conj(s_c) ds_c/dx_j).
// dense_grad_kernel computes, one thread a patch:
//   1. psi(theta_c) of every class, once a block, into shared memory (a
//      warp a class, through warp_evolve on the trainable register's ops);
//   2. the patch's factors f_q and their angle derivatives, in registers;
//   3. per class the environments e_q[bit] = sum over the amplitudes a with
//      a_q = bit of psi_a * prod_{k != q} conj(f_k[a_k]) (a prefix product
//      and a suffix product an amplitude), then s_c = sum_bit
//      conj(f_q[bit]) e_q[bit] and ds_c/dx_j = sum_bit conj(df_j[bit])
//      e_q[bit];
//   4. dL/dx_j = sum_c w[b, c] dF_c/dx_j, where w is dL/dF of one patch of
//      image b (the loss's chain weight, its clamp masks and the means
//      folded in by the caller), and a patch whose F_c exceeds 1 contributes
//      nothing to class c (the fidelity's clamp to [0, 1]; F >= 0 always),
//      while a NaN F_c or weight carries into the gradient, as under autograd;
//   5. dL/dz_j = dL/dx_j * x_j (1 - x_j / pi), the sigmoid's derivative read
//      from the angle itself;
//   6. the block's partial dW = sum_p patch_p (x) dL/dz_p and db = sum_p
//      dL/dz_p over its patches, tile by tile in shared memory, each element
//      summed by one thread over the patches in order.
// dense_reduce_kernel then sums the blocks' partials in block order.  No
// float atomics anywhere: a call's bits depend only on its inputs and the
// block count (from the device's SM count), so two calls agree bit for bit.
//
// Bound on an H100 at 7q-3l (m = 3, 9 patches of 16 pixels an image, two
// classes): per patch 16 + 6 floats in and, per class, 8 amplitudes times
// about 3m complex multiply-adds, so reading the 36,864 patches of a batch of
// 4,096 (3.2 MB) bounds it, about 1 us; the psi preparation is a warp's few
// gates a block.
#include "statevector.cuh"

namespace vqc {

// one thread a patch, a tile of this many patches
constexpr int kDenseThreads = 128;
// encoding rotations a data qubit holds (QuClassi's RX and RY)
constexpr int kSlots = 2;
constexpr float kPi = 3.14159265358979323846f;

struct Amp {
  float re, im;
};

__device__ __forceinline__ Amp cmul(Amp a, Amp b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ Amp conj(Amp a) { return {a.re, -a.im}; }

__device__ __forceinline__ void cadd(Amp& acc, Amp a) {
  acc.re += a.re;
  acc.im += a.im;
}

// Qubit q's factor, its slots' rotations applied to |0> with the cos / sin
// of their half angles; slot `shifted` (when >= 0) takes R(a + pi) / 2,
// the derivative of its rotation.
template <int M>
__device__ __forceinline__ void qubit_factor(const int* slots, const float (&c)[M][kSlots],
                                             const float (&sn)[M][kSlots], int q, int shifted,
                                             Amp (&out)[2]) {
  float r0 = 1.f, m0 = 0.f, r1 = 0.f, m1 = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int g = slots[(q * kSlots + k) * kOpFields];
    if (k == shifted) {
      rot1(g, -sn[q][k], c[q][k], r0, m0, r1, m1);
    } else {
      rot1(g, c[q][k], sn[q][k], r0, m0, r1, m1);
    }
  }
  const float scale = shifted >= 0 ? 0.5f : 1.f;
  out[0] = {r0 * scale, m0 * scale};
  out[1] = {r1 * scale, m1 * scale};
}

// dL/dz of one patch into dz (n_angles floats, zeroed by the caller).
template <int M>
__device__ __forceinline__ void patch_grad(const float* psi, int n_classes, const int* slots,
                                           const float* slot_consts, const float* x,
                                           const float* w, float* dz) {
  constexpr int dim = 1 << M;
  float c[M][kSlots], sn[M][kSlots];
#pragma unroll
  for (int q = 0; q < M; ++q) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int* op = slots + (q * kSlots + k) * kOpFields;
      op_angle(op, slot_consts[q * kSlots + k], nullptr, x, 0.f, c[q][k], sn[q][k]);
    }
  }
  Amp f[M][2], df[M][kSlots][2];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    qubit_factor<M>(slots, c, sn, q, -1, f[q]);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) qubit_factor<M>(slots, c, sn, q, k, df[q][k]);
  }
  float dl[M][kSlots];
#pragma unroll
  for (int q = 0; q < M; ++q) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) dl[q][k] = 0.f;
  }
  for (int cl = 0; cl < n_classes; ++cl) {
    const float* pre = psi + cl * 2 * dim;
    const float* pim = pre + dim;
    Amp e[M][2], s = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < M; ++q) e[q][0] = e[q][1] = {0.f, 0.f};
#pragma unroll 1
    for (int a = 0; a < dim; ++a) {
      Amp v[M], pfx[M];
#pragma unroll
      for (int q = 0; q < M; ++q) v[q] = conj((a >> (M - 1 - q)) & 1 ? f[q][1] : f[q][0]);
      pfx[0] = {1.f, 0.f};
#pragma unroll
      for (int q = 1; q < M; ++q) pfx[q] = cmul(pfx[q - 1], v[q - 1]);
      Amp sfx = {pre[a], pim[a]};
#pragma unroll
      for (int q = M - 1; q >= 0; --q) {
        const Amp t = cmul(pfx[q], sfx);
        if ((a >> (M - 1 - q)) & 1) {
          cadd(e[q][1], t);
        } else {
          cadd(e[q][0], t);
        }
        sfx = cmul(sfx, v[q]);
      }
      cadd(s, sfx);
    }
    const float fid = s.re * s.re + s.im * s.im;
    const float wc = w[cl];
    if (fid > 1.f || wc == 0.f) continue;  // a NaN fidelity or weight carries on
#pragma unroll
    for (int q = 0; q < M; ++q) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const Amp ds0 = cmul(conj(df[q][k][0]), e[q][0]), ds1 = cmul(conj(df[q][k][1]), e[q][1]);
        const float dsr = ds0.re + ds1.re, dsi = ds0.im + ds1.im;
        dl[q][k] += wc * (2.f * (s.re * dsr + s.im * dsi));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < M; ++q) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = slots[(q * kSlots + k) * kOpFields + 5];  // the op's data angle
      dz[j] = dl[q][k] * (x[j] * (1.f - x[j] / kPi));
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kDenseThreads)
dense_grad_kernel(const float* __restrict__ theta, int n_theta, int n_classes,
                  const int* __restrict__ train_ops, const float* __restrict__ train_consts,
                  int n_train_ops, const int* __restrict__ slots,
                  const float* __restrict__ slot_consts, const float* __restrict__ angles,
                  int n_angles, const float* __restrict__ patches, int patch_dim,
                  const float* __restrict__ weights, int per_image, long n_rows,
                  int tiles_per_block, float* __restrict__ partial) {
  extern __shared__ float smem[];
  constexpr int dim = 1 << M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int n_elems = patch_dim * n_angles + n_angles;
  float* psi = smem;                                    // [class][re: dim | im: dim]
  float* tile_x = psi + n_classes * 2 * dim;            // [patch][patch_dim]
  float* tile_dz = tile_x + kDenseThreads * patch_dim;  // [patch][n_angles]
  float* acc = tile_dz + kDenseThreads * n_angles;      // [n_elems]: dW row-major, then db

  // 1. psi(theta_c), a warp a class
  for (int cl = warp; cl < n_classes; cl += warps) {
    const WarpState st{psi + cl * 2 * dim, psi + cl * 2 * dim + dim};
    warp_zero(st, dim, lane);
    warp_evolve(train_ops, train_consts, n_train_ops, theta + static_cast<long>(cl) * n_theta,
                nullptr, st, M, lane);
  }
  for (int e = tid; e < n_elems; e += kDenseThreads) acc[e] = 0.f;
  __syncthreads();

  const long first = static_cast<long>(blockIdx.x) * tiles_per_block * kDenseThreads;
  for (int t = 0; t < tiles_per_block; ++t) {
    const long base = first + static_cast<long>(t) * kDenseThreads;
    if (base >= n_rows) break;  // the same on every thread of the block
    const int rows = n_rows - base < kDenseThreads ? static_cast<int>(n_rows - base) : kDenseThreads;
    for (int i = tid; i < kDenseThreads * patch_dim; i += kDenseThreads) {
      tile_x[i] = i < rows * patch_dim ? patches[base * patch_dim + i] : 0.f;
    }
    float* dz = tile_dz + tid * n_angles;
    for (int j = 0; j < n_angles; ++j) dz[j] = 0.f;
    if (tid < rows) {
      const long row = base + tid;
      patch_grad<M>(psi, n_classes, slots, slot_consts, angles + row * n_angles,
                    weights + (row / per_image) * n_classes, dz);
    }
    __syncthreads();
    // 6. each element of the partial summed by one thread, patches in order
    for (int e = tid; e < n_elems; e += kDenseThreads) {
      const int i = e / n_angles, j = e - i * n_angles;
      float sum = acc[e];
      if (i < patch_dim) {
#pragma unroll 4
        for (int p = 0; p < rows; ++p) {
          sum = fmaf(tile_x[p * patch_dim + i], tile_dz[p * n_angles + j], sum);
        }
      } else {
#pragma unroll 4
        for (int p = 0; p < rows; ++p) sum += tile_dz[p * n_angles + j];
      }
      acc[e] = sum;
    }
    __syncthreads();
  }
  for (int e = tid; e < n_elems; e += kDenseThreads) {
    partial[static_cast<long>(blockIdx.x) * n_elems + e] = acc[e];
  }
}

__global__ void __launch_bounds__(kDenseThreads)
dense_reduce_kernel(const float* __restrict__ partial, int n_blocks, int n_elems,
                    float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  float sum = 0.f;
  for (int g = 0; g < n_blocks; ++g) sum += partial[static_cast<long>(g) * n_elems + e];
  out[e] = sum;
}

template <int M>
cudaError_t launch_dense_grad(const float* theta, int n_theta, int n_classes,
                              const int* train_ops, const float* train_consts, int n_train_ops,
                              const int* slots, const float* slot_consts, const float* angles,
                              int n_angles, const float* patches, int patch_dim,
                              const float* weights, int per_image, long n_rows,
                              int tiles_per_block, int n_blocks, float* partial, int smem_bytes,
                              cudaStream_t stream) {
  const cudaError_t err = allow_smem(dense_grad_kernel<M>, smem_bytes);
  if (err != cudaSuccess) return err;
  dense_grad_kernel<M><<<n_blocks, kDenseThreads, smem_bytes, stream>>>(
      theta, n_theta, n_classes, train_ops, train_consts, n_train_ops, slots, slot_consts,
      angles, n_angles, patches, patch_dim, weights, per_image, n_rows, tiles_per_block,
      partial);
  return cudaGetLastError();
}

}  // namespace vqc

extern "C" int vqc_dense_grad_launch(const float* theta, int n_theta, int n_classes,
                                     const int* train_ops, const float* train_consts,
                                     int n_train_ops, const int* slots,
                                     const float* slot_consts, int m, const float* angles,
                                     int n_angles, const float* patches, int patch_dim,
                                     const float* weights, int per_image, long long n_rows,
                                     int tiles_per_block, int n_blocks, float* partial,
                                     int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VQC_DENSE_CASE(M)                                                                    \
  case M:                                                                                    \
    return static_cast<int>(vqc::launch_dense_grad<M>(                                     \
        theta, n_theta, n_classes, train_ops, train_consts, n_train_ops, slots, slot_consts, \
        angles, n_angles, patches, patch_dim, weights, per_image, n_rows, tiles_per_block,  \
        n_blocks, partial, smem_bytes, s));
  switch (m) {
    VQC_DENSE_CASE(1) VQC_DENSE_CASE(2) VQC_DENSE_CASE(3) VQC_DENSE_CASE(4)
    VQC_DENSE_CASE(5) VQC_DENSE_CASE(6) VQC_DENSE_CASE(7) VQC_DENSE_CASE(8)
    VQC_DENSE_CASE(9) VQC_DENSE_CASE(10) VQC_DENSE_CASE(11) VQC_DENSE_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VQC_DENSE_CASE
}

extern "C" int vqc_dense_reduce_launch(const float* partial, int n_blocks, int n_elems,
                                       float* out, void* stream) {
  const int grid = (n_elems + vqc::kDenseThreads - 1) / vqc::kDenseThreads;
  vqc::dense_reduce_kernel<<<grid, vqc::kDenseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_blocks, n_elems, out);
  return static_cast<int>(cudaGetLastError());
}
