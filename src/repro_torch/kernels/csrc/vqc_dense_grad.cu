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
//
// The wide route (registers of m = 13-16 qubits, kernels/dense_grad.py) takes
// the same environments where psi of two classes (64-512 KB a class) no longer
// fits a block's shared memory, and where a batch has too few patches to fill
// the card one thread a patch (576 at the paper's batch of 64):
//   * dense_wide_psi_kernel builds psi(theta_c) once a class a call, a block
//     a class, into device memory (in shared memory first where it fits);
//   * dense_wide_kernel gives a block of kWideThreads threads a patch at a
//     time.  The amplitude index splits into its ML = min(m, 8) least
//     significant qubits, fixed by the thread (lo = its index), and the
//     MH = m - ML most significant ones, swept by every thread.  The
//     products over the swept qubits, H(i) = prod_q conj(f_q[i_q]) and
//     H_q(i) = the same without qubit q, are a table in shared memory, made
//     once a patch; those over the thread's own qubits, L and L_k, are
//     constants of the thread.  So the thread sums T = sum_i psi[i, lo] H(i)
//     and E_q[bit] = sum_{i: i_q = bit} psi[i, lo] H_q(i), and its share of
//     s_c is T L, of e_q[bit] E_q[bit] L for a swept qubit and T L_k for its
//     own qubit k at its own bit.  The block sums the shares in a fixed
//     order (a butterfly within each warp, then the warps in order), and
//     steps 4-6 follow as above, a thread an angle, the block's partial
//     summed patch by patch in order.  dense_reduce_kernel sums the partials.
// At 27q-3l, batch 64 (576 patches, two classes) the least work any route
// does is one inner product of 2^13 amplitudes a (class, patch) and psi's
// gates once a class, about 82 Mflop (1.2 us at the float32 peak); the
// kernel reads psi from L2 once a (class, patch), 75 MB.
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

// ------------------------------------------------------------ the wide route
// threads of dense_wide_kernel, one amplitude of every 2^kWideLoBits a class
constexpr int kWideThreads = 256;
constexpr int kWideLoBits = 8;
// threads of dense_wide_psi_kernel, a block a class
constexpr int kPsiThreads = 1024;

// psi(theta_c) of class blockIdx.x into psi[c][re: dim | im: dim]: the
// trainable register's ops, each over the block's threads pair by pair with
// a barrier between two ops (the arithmetic of warp_apply, so the bits of
// the register kernel's psi).  The op table and each op's cos / sin, worked
// out once a block, sit in shared memory; the state too where
// state_in_smem (m <= 14), copied out at the end, else it is built in
// place in device memory.
__global__ void __launch_bounds__(kPsiThreads)
dense_wide_psi_kernel(const float* __restrict__ theta, int n_theta,
                      const int* __restrict__ train_ops, const float* __restrict__ train_consts,
                      int n_train_ops, int m, float* psi, int state_in_smem) {
  extern __shared__ __align__(16) float psi_smem[];
  const int tid = threadIdx.x;
  const int dim = 1 << m;
  float* cs = psi_smem;                                               // [op][cos, sin]
  int* ops = reinterpret_cast<int*>(cs + 2 * n_train_ops);            // [op][kOpFields]
  float* state = reinterpret_cast<float*>(ops + kOpFields * n_train_ops);
  float* out = psi + static_cast<long>(blockIdx.x) * 2 * dim;
  float* re = state_in_smem ? state : out;
  float* im = re + dim;
  const float* th = theta + static_cast<long>(blockIdx.x) * n_theta;
  for (int k = tid; k < n_train_ops; k += kPsiThreads) {
    op_angle(train_ops + k * kOpFields, train_consts[k], th, nullptr, 0.f, cs[2 * k],
             cs[2 * k + 1]);
  }
  for (int i = tid; i < kOpFields * n_train_ops; i += kPsiThreads) ops[i] = train_ops[i];
  for (int a = tid; a < dim; a += kPsiThreads) {
    re[a] = a == 0 ? 1.f : 0.f;
    im[a] = 0.f;
  }
  __syncthreads();
  for (int k = 0; k < n_train_ops; ++k) {
    strided_apply<int>(ops + k * kOpFields, cs[2 * k], cs[2 * k + 1], re, im, m, tid,
                       kPsiThreads);
    __syncthreads();
  }
  if (state_in_smem) {
    for (int a = tid; a < 2 * dim; a += kPsiThreads) out[a] = state[a];
  }
}

// Qubit q's factor from the cos / sin of its slots' half angles in cs
// ([slot row][cos, sin]); slot `shifted` (when >= 0) takes its derivative.
__device__ __forceinline__ void slot_factor(const int* slots, const float* cs, int q,
                                            int shifted, Amp (&out)[2]) {
  float r0 = 1.f, m0 = 0.f, r1 = 0.f, m1 = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = q * kSlots + k;
    const int g = slots[r * kOpFields];
    if (k == shifted) {
      rot1(g, -cs[2 * r + 1], cs[2 * r], r0, m0, r1, m1);
    } else {
      rot1(g, cs[2 * r], cs[2 * r + 1], r0, m0, r1, m1);
    }
  }
  const float scale = shifted >= 0 ? 0.5f : 1.f;
  out[0] = {r0 * scale, m0 * scale};
  out[1] = {r1 * scale, m1 * scale};
}

// The warp's sum of z into red[v] (re) and red[v + 1] (im), by lane 0.
__device__ __forceinline__ void warp_put(float* red, int v, Amp z, int lane) {
  const float re = warp_sum(z.re), im = warp_sum(z.im);
  if (lane == 0) {
    red[v] = re;
    red[v + 1] = im;
  }
}

template <int M>
__global__ void __launch_bounds__(kWideThreads)
dense_wide_kernel(const float* __restrict__ psi, int n_classes, const int* __restrict__ slots,
                  const float* __restrict__ slot_consts, const float* __restrict__ angles,
                  int n_angles, const float* __restrict__ patches, int patch_dim,
                  const float* __restrict__ weights, int per_image, long n_rows,
                  int rows_per_block, float* __restrict__ partial) {
  constexpr int dim = 1 << M;
  constexpr int ML = M < kWideLoBits ? M : kWideLoBits;  // the thread's qubits MH .. M - 1
  constexpr int MH = M - ML;                             // the swept qubits 0 .. MH - 1
  constexpr int NH = 1 << MH;
  constexpr int HS = MH + 1;                             // a table row: H, then H_q
  constexpr int NV = 2 + 4 * M;                          // s, then e_q[0], e_q[1] (re, im)
  constexpr int kWarps = kWideThreads / 32;
  extern __shared__ __align__(16) float wide_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_elems = patch_dim * n_angles + n_angles;
  Amp* tab = reinterpret_cast<Amp*>(wide_smem);      // [NH][HS]
  float* red = wide_smem + 2 * NH * HS;              // [warp][class][NV]
  float* tot = red + kWarps * n_classes * NV;        // [class][NV]
  float* cs = tot + n_classes * NV;                  // [slot row][cos, sin]
  float* dz = cs + 2 * n_angles;                     // [n_angles]
  float* acc = dz + n_angles;                        // [n_elems]: dW row-major, then db
  const int lo = tid & ((1 << ML) - 1);
  const bool active = tid < (1 << ML);

  for (int e = tid; e < n_elems; e += kWideThreads) acc[e] = 0.f;
  const long first = static_cast<long>(blockIdx.x) * rows_per_block;
  const long last = first + rows_per_block < n_rows ? first + rows_per_block : n_rows;
  for (long row = first; row < last; ++row) {
    const float* x = angles + row * n_angles;
    if (tid < kSlots * M) {
      op_angle(slots + tid * kOpFields, slot_consts[tid], nullptr, x, 0.f, cs[2 * tid],
               cs[2 * tid + 1]);
    }
    __syncthreads();
    Amp f[M][2];
#pragma unroll
    for (int q = 0; q < M; ++q) slot_factor(slots, cs, q, -1, f[q]);
    // the swept qubits' table, a row an index i of them
    for (int i = tid; i < NH; i += kWideThreads) {
      Amp v[HS], pfx[HS];
#pragma unroll
      for (int q = 0; q < MH; ++q) v[q] = conj(f[q][(i >> (MH - 1 - q)) & 1]);
      pfx[0] = {1.f, 0.f};
#pragma unroll
      for (int q = 1; q < MH; ++q) pfx[q] = cmul(pfx[q - 1], v[q - 1]);
      Amp sfx = {1.f, 0.f};
#pragma unroll
      for (int q = MH - 1; q >= 0; --q) {
        tab[i * HS + 1 + q] = cmul(pfx[q], sfx);
        sfx = cmul(sfx, v[q]);
      }
      tab[i * HS] = sfx;
    }
    // the thread's own qubits: L and L_k
    Amp lx[ML], lpfx[ML], l = {1.f, 0.f};
    {
      Amp vl[ML];
#pragma unroll
      for (int k = 0; k < ML; ++k) vl[k] = conj(f[MH + k][(lo >> (ML - 1 - k)) & 1]);
      lpfx[0] = {1.f, 0.f};
#pragma unroll
      for (int k = 1; k < ML; ++k) lpfx[k] = cmul(lpfx[k - 1], vl[k - 1]);
#pragma unroll
      for (int k = ML - 1; k >= 0; --k) {
        lx[k] = cmul(lpfx[k], l);
        l = cmul(l, vl[k]);
      }
    }
    __syncthreads();
    for (int cl = 0; cl < n_classes; ++cl) {
      const float* pre = psi + static_cast<long>(cl) * 2 * dim;
      const float* pim = pre + dim;
      Amp t = {0.f, 0.f}, e0[HS], e1[HS];
#pragma unroll
      for (int q = 0; q < MH; ++q) e0[q] = e1[q] = {0.f, 0.f};
      if (active) {
#pragma unroll 4
        for (int i = 0; i < NH; ++i) {
          const int a = (i << ML) | lo;
          const Amp p = {pre[a], pim[a]};
          const Amp* r = tab + i * HS;
          cadd(t, cmul(p, r[0]));
#pragma unroll
          for (int q = 0; q < MH; ++q) {
            const Amp u = cmul(p, r[1 + q]);
            if ((i >> (MH - 1 - q)) & 1) {
              cadd(e1[q], u);
            } else {
              cadd(e0[q], u);
            }
          }
        }
      }
      float* mine = red + (warp * n_classes + cl) * NV;
      warp_put(mine, 0, cmul(t, l), lane);
#pragma unroll
      for (int q = 0; q < MH; ++q) {
        warp_put(mine, 2 + 4 * q, cmul(e0[q], l), lane);
        warp_put(mine, 4 + 4 * q, cmul(e1[q], l), lane);
      }
#pragma unroll
      for (int k = 0; k < ML; ++k) {
        const Amp u = cmul(t, lx[k]), zero = {0.f, 0.f};
        const bool one = (lo >> (ML - 1 - k)) & 1;
        warp_put(mine, 2 + 4 * (MH + k), one ? zero : u, lane);
        warp_put(mine, 4 + 4 * (MH + k), one ? u : zero, lane);
      }
    }
    __syncthreads();
    for (int v = tid; v < n_classes * NV; v += kWideThreads) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[w * n_classes * NV + v];
      tot[v] = sum;
    }
    __syncthreads();
    // 4-5: a thread a slot row (qubit q, slot k), its angle's dL/dz
    if (tid < kSlots * M) {
      const int q = tid / kSlots, k = tid - q * kSlots;
      Amp df[2];
      slot_factor(slots, cs, q, k, df);
      const float* w = weights + (row / per_image) * n_classes;
      float dl = 0.f;
      for (int cl = 0; cl < n_classes; ++cl) {
        const float* v = tot + cl * NV;
        const Amp s = {v[0], v[1]};
        const float fid = s.re * s.re + s.im * s.im;
        const float wc = w[cl];
        if (fid > 1.f || wc == 0.f) continue;  // a NaN fidelity or weight carries on
        const Amp ds0 = cmul(conj(df[0]), Amp{v[2 + 4 * q], v[3 + 4 * q]});
        const Amp ds1 = cmul(conj(df[1]), Amp{v[4 + 4 * q], v[5 + 4 * q]});
        const float dsr = ds0.re + ds1.re, dsi = ds0.im + ds1.im;
        dl += wc * (2.f * (s.re * dsr + s.im * dsi));
      }
      const int j = slots[tid * kOpFields + 5];  // the op's data angle
      dz[j] = dl * (x[j] * (1.f - x[j] / kPi));
    }
    __syncthreads();
    // 6: each element of the partial summed by one thread, patches in order
    for (int e = tid; e < n_elems; e += kWideThreads) {
      const int i = e / n_angles, j = e - i * n_angles;
      acc[e] = i < patch_dim ? fmaf(patches[row * patch_dim + i], dz[j], acc[e]) : acc[e] + dz[j];
    }
    __syncthreads();
  }
  for (int e = tid; e < n_elems; e += kWideThreads) {
    partial[static_cast<long>(blockIdx.x) * n_elems + e] = acc[e];
  }
}

template <int M>
cudaError_t launch_dense_wide(const float* psi, int n_classes, const int* slots,
                              const float* slot_consts, const float* angles, int n_angles,
                              const float* patches, int patch_dim, const float* weights,
                              int per_image, long n_rows, int rows_per_block, int n_blocks,
                              float* partial, int smem_bytes, cudaStream_t stream) {
  const cudaError_t err = allow_smem(dense_wide_kernel<M>, smem_bytes);
  if (err != cudaSuccess) return err;
  dense_wide_kernel<M><<<n_blocks, kWideThreads, smem_bytes, stream>>>(
      psi, n_classes, slots, slot_consts, angles, n_angles, patches, patch_dim, weights,
      per_image, n_rows, rows_per_block, partial);
  return cudaGetLastError();
}

}  // namespace vqc

extern "C" int vqc_dense_wide_psi_launch(const float* theta, int n_theta, int n_classes,
                                         const int* train_ops, const float* train_consts,
                                         int n_train_ops, int m, float* psi, int state_in_smem,
                                         int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::dense_wide_psi_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vqc::dense_wide_psi_kernel<<<n_classes, vqc::kPsiThreads, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      theta, n_theta, train_ops, train_consts, n_train_ops, m, psi, state_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_dense_wide_launch(const float* psi, int n_classes, const int* slots,
                                     const float* slot_consts, int m, const float* angles,
                                     int n_angles, const float* patches, int patch_dim,
                                     const float* weights, int per_image, long long n_rows,
                                     int rows_per_block, int n_blocks, float* partial,
                                     int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VQC_WIDE_CASE(M)                                                                    \
  case M:                                                                                   \
    return static_cast<int>(vqc::launch_dense_wide<M>(                                    \
        psi, n_classes, slots, slot_consts, angles, n_angles, patches, patch_dim, weights, \
        per_image, n_rows, rows_per_block, n_blocks, partial, smem_bytes, s));
  // the widths route_plan gives the wide route (13-16), and 2, 3 and 12,
  // which the card tests force onto it against the register kernel
  switch (m) {
    VQC_WIDE_CASE(2) VQC_WIDE_CASE(3) VQC_WIDE_CASE(12)
    VQC_WIDE_CASE(13) VQC_WIDE_CASE(14) VQC_WIDE_CASE(15) VQC_WIDE_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VQC_WIDE_CASE
}

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
