// Fused full-circuit statevector kernels (kernels 1 and 2 of the port).
//
// fidelity_kernel replaces repro/kernels/vqc_statevector.py::_fidelity_kernel
// (launched from _grid_call): evolve each circuit of the batch from |0...0>
// through the spec's op table with its own angles (theta row c, data row c)
// and write the ancilla P(0).  Materialized banks and per-worker row
// batches take it.
//
//   One warp per circuit, W warps a block (fused_geometry in
//   vqc_statevector.py), the circuit's state in the warp's slice of dynamic
//   shared memory (2 * 4 * 2^n bytes: 1 KB at n = 7).  Each gate is one
//   pass of the 32 lanes over its amplitude pairs (2 pairs a lane for a
//   one-qubit gate at n = 7) followed by __syncwarp(); no block barrier.
//   The op angles are computed 32 at a time, lane k taking op k (the same
//   cosf/sinf of the same argument as the one-thread kernel it replaces),
//   and broadcast with __shfl_sync.  P(0) is each lane's partial sum over
//   the first half of the amplitudes, then a warp reduction.
//
//   Bound on an H100: device memory moves only (P + D) * 4 bytes in and 4
//   bytes out per circuit against some 6 flops per amplitude per rotation,
//   so the float32 arithmetic bounds it.  The kernel this replaced gave
//   each circuit one thread that walked the whole state serially (2^(n-1)
//   dependent shared-memory read-modify-writes a gate) in blocks of 128
//   circuits, 33 blocks of 4 warps at C = 4,176: latency-bound on a
//   quarter of the SMs.  A warp per circuit makes the 4,176 circuits 4,176
//   warps over every SM and cuts each gate's serial chain 32-fold.
//
// state_kernel replaces ::_state_kernel: the same evolution, one thread per
// circuit with its state in a shared-memory column ([amp][circuit], blocks
// from kernel_tb), writing the final (re, im) state.  It is off the
// training path (tests and the smoke only).
#include "statevector.cuh"

namespace vqc {

__global__ void __launch_bounds__(1024)
fidelity_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                int n_circuits, int n_theta, int n_data,
                const int* __restrict__ ops, const float* __restrict__ consts, int n_ops,
                int n_qubits, float* __restrict__ p0_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  // The whole warp is one circuit, so this exit is warp-uniform: a warp
  // past the batch (the ragged last block) leaves before any shuffle, and
  // no block barrier follows.
  if (c >= n_circuits) return;
  const int dim = 1 << n_qubits;
  const WarpState s{smem + static_cast<long>(warp) * 2 * dim,
                    smem + static_cast<long>(warp) * 2 * dim + dim};
  warp_zero(s, dim, lane);
  const float* th = theta + c * n_theta;
  const float* dt = data + c * n_data;
  for (int k0 = 0; k0 < n_ops; k0 += 32) {
    float my_c = 0.f, my_s = 0.f;
    if (k0 + lane < n_ops) {
      op_angle(ops + (k0 + lane) * kOpFields, consts[k0 + lane], th, dt, 0.f, my_c, my_s);
    }
    const int kn = min(32, n_ops - k0);
    for (int j = 0; j < kn; ++j) {
      const float cj = __shfl_sync(kFullMask, my_c, j), sj = __shfl_sync(kFullMask, my_s, j);
      warp_apply(ops + (k0 + j) * kOpFields, cj, sj, s, n_qubits, lane);
    }
  }
  float p0 = 0.f;  // ancilla = MSB: the first half of the amplitudes
  for (int a = lane; a < dim / 2; a += 32) p0 += s.re[a] * s.re[a] + s.im[a] * s.im[a];
  p0 = warp_sum(p0);
  if (lane == 0) p0_out[c] = p0;
}

__global__ void __launch_bounds__(1024)
state_kernel(const float* __restrict__ theta, const float* __restrict__ data,
             int n_circuits, int n_theta, int n_data,
             const int* __restrict__ ops, const float* __restrict__ consts, int n_ops,
             int n_qubits, float* __restrict__ re_out, float* __restrict__ im_out) {
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x;
  const long c = static_cast<long>(blockIdx.x) * tb + lane;
  if (c >= n_circuits) return;  // ragged last block; no barriers follow
  const int dim = 1 << n_qubits;
  const Col s{smem + lane, smem + dim * tb + lane, tb};
  zero_state(s, dim);
  const float* th = theta + c * n_theta;
  const float* dt = data + c * n_data;
  for (int k = 0; k < n_ops; ++k) {
    apply_op(ops + k * kOpFields, consts[k], s, n_qubits, th, dt, 0.f, false);
  }
  for (int a = 0; a < dim; ++a) {
    re_out[c * dim + a] = s.r(a);
    im_out[c * dim + a] = s.i(a);
  }
}

}  // namespace vqc

extern "C" int vqc_fidelity_launch(const float* theta, const float* data, int n_circuits,
                                   int n_theta, int n_data, const int* ops, const float* consts,
                                   int n_ops, int n_qubits, float* p0_out, int warps,
                                   int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::fidelity_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_circuits + warps - 1) / warps);
  vqc::fidelity_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits, p0_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_state_launch(const float* theta, const float* data, int n_circuits,
                                int n_theta, int n_data, const int* ops, const float* consts,
                                int n_ops, int n_qubits, float* re_out, float* im_out, int tb,
                                int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::state_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_circuits + tb - 1) / tb);
  vqc::state_kernel<<<grid, tb, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits, re_out, im_out);
  return static_cast<int>(cudaGetLastError());
}
