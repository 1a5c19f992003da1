// Fused full-circuit statevector kernel (kernels 1 and 2 of the port).
//
// Replaces repro/kernels/vqc_statevector.py::_fidelity_kernel (want_state =
// false: writes the ancilla P(0)) and ::_state_kernel (want_state = true:
// writes the final (re, im) state), both launched from _grid_call.
//
// One thread simulates one circuit of the batch from |0...0> through the
// spec's op table, with its own angles (theta row c, data row c), then
// reads out.  The state lives in dynamic shared memory, one column per
// thread ([amp][circuit]), 2 * 4 * 2^n bytes per circuit: 1 KB at n = 7,
// so a 227 KB block holds 128 circuits.
//
// Bound on an H100: device memory moves only (P + D) * 4 bytes in and 4
// bytes out per circuit (8 * 2^n out for the state variant), against some
// 6 flops per amplitude per rotation, so the float32 arithmetic bounds it;
// in practice the per-gate read-modify-write sweeps through shared memory
// and the few warps a 128-circuit block leaves per SM bound it first.  The
// design keeps every state out of device memory; restructuring the gate
// sweeps for more circuits in flight is later work.
#include "statevector.cuh"

namespace vqc {

template <bool kWantState>
__global__ void __launch_bounds__(1024)
fused_kernel(const float* __restrict__ theta, const float* __restrict__ data,
             int n_circuits, int n_theta, int n_data,
             const int* __restrict__ ops, const float* __restrict__ consts, int n_ops,
             int n_qubits, float* __restrict__ p0_out,
             float* __restrict__ re_out, float* __restrict__ im_out) {
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
  if (kWantState) {
    for (int a = 0; a < dim; ++a) {
      re_out[c * dim + a] = s.r(a);
      im_out[c * dim + a] = s.i(a);
    }
  } else {
    float p0 = 0.f;  // ancilla = MSB: the first half of the amplitudes
    for (int a = 0; a < dim / 2; ++a) p0 += s.r(a) * s.r(a) + s.i(a) * s.i(a);
    p0_out[c] = p0;
  }
}

}  // namespace vqc

extern "C" int vqc_fused_launch(const float* theta, const float* data, int n_circuits,
                                int n_theta, int n_data, const int* ops, const float* consts,
                                int n_ops, int n_qubits, float* p0_out, float* re_out,
                                float* im_out, int want_state, int tb, int smem_bytes,
                                void* stream) {
  const dim3 grid((n_circuits + tb - 1) / tb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (want_state) {
    err = vqc::allow_smem(vqc::fused_kernel<true>, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    vqc::fused_kernel<true><<<grid, tb, smem_bytes, st>>>(
        theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits,
        p0_out, re_out, im_out);
  } else {
    err = vqc::allow_smem(vqc::fused_kernel<false>, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    vqc::fused_kernel<false><<<grid, tb, smem_bytes, st>>>(
        theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits,
        p0_out, re_out, im_out);
  }
  return static_cast<int>(cudaGetLastError());
}
