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
// state_kernel replaces ::_state_kernel: the same evolution on the same
// geometry (fused_geometry), ending in a store of the final (re, im) state
// instead of the P(0) reduction.  Lane l writes amplitudes l, l + 32, ...
// of its circuit's row, so a warp's stores are coalesced.  Bound on an
// H100: its 2 * 4 * 2^n bytes of output per circuit (bytes, where the
// fidelity kernel is arithmetic-bound).  The one-thread kernel it replaced
// needed a warp of 32 states a block and refused 10 qubits and more; this
// one runs up to 14.  It is off the training path (tests and the smoke).
#include "statevector.cuh"

namespace vqc {

// The circuit's evolution from |0...0>, shared by both kernels: the
// warp's state in its slice of dynamic shared memory.
__device__ __forceinline__ WarpState evolve_circuit(float* smem, const float* theta,
                                                    const float* data, long c, int n_theta,
                                                    int n_data, const int* ops,
                                                    const float* consts, int n_ops,
                                                    int n_qubits, int warp, int lane) {
  const int dim = 1 << n_qubits;
  const WarpState s{smem + static_cast<long>(warp) * 2 * dim,
                    smem + static_cast<long>(warp) * 2 * dim + dim};
  warp_zero(s, dim, lane);
  warp_evolve(ops, consts, n_ops, theta + c * n_theta, data + c * n_data, s, n_qubits, lane);
  return s;
}

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
  const WarpState s = evolve_circuit(smem, theta, data, c, n_theta, n_data, ops, consts, n_ops,
                                     n_qubits, warp, lane);
  const int dim = 1 << n_qubits;
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (c >= n_circuits) return;  // warp-uniform, as in fidelity_kernel
  const WarpState s = evolve_circuit(smem, theta, data, c, n_theta, n_data, ops, consts, n_ops,
                                     n_qubits, warp, lane);
  const int dim = 1 << n_qubits;
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    re_out[c * dim + a] = s.re[a];
    im_out[c * dim + a] = s.im[a];
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
                                int n_ops, int n_qubits, float* re_out, float* im_out, int warps,
                                int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::state_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_circuits + warps - 1) / warps);
  vqc::state_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits, re_out, im_out);
  return static_cast<int>(cudaGetLastError());
}
