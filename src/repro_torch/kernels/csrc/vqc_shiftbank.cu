// Prefix-reuse shift-bank kernel (kernel 3 of the port).
//
// Replaces repro/kernels/vqc_statevector.py::_shiftbank_kernel, the
// single-sweep branch of vqc_shift_fidelity.  For a SWAP-test circuit the
// fidelity is |<psi_d|psi_t>|^2 of two m-qubit register states, so each
// thread (one sample of the implicit bank) runs:
//   1. the data register's ops once;
//   2. the trainable register forward with base angles, copying the state
//      into a checkpoint slot before each anchored parameter's first gate;
//   3. the base fidelity f0, written to every row that takes it;
//   4. chi = psi_d walked backward through the inverted train ops down to
//      the lowest anchor; at each anchor, every variant anchored there
//      replays its parameter's [first, last] span from its checkpoint with
//      the shift added to that parameter's gates, and writes |<chi|v>|^2.
// The shift plan arrives as tables (see _ShiftTable in
// vqc_statevector.py), so one build serves every circuit and group set.
//
// Shared memory per sample: (n_ckpt + 4) states of 2 * 4 * 2^m bytes (data,
// running, chi, variant + checkpoints): 1152 bytes at m = 3 with 14
// checkpoints, so a 227 KB block holds 128 samples.  A plan whose
// checkpoints do not fit one warp's block needs the spill kernels, which
// the wrapper refuses before launch.
//
// Bound on an H100: per sample (P + D) * 4 bytes in and 4 bytes per
// requested row out, against the float32 arithmetic of every register-
// local gate application, so arithmetic bounds it; the per-gate sweeps
// through shared memory and the few warps a block leaves per SM bound it
// first in practice.
#include "statevector.cuh"

namespace vqc {

// A variant-table row: output row, param, first, last, anchor.
constexpr int kVarFields = 5;

__global__ void __launch_bounds__(1024)
shiftbank_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                 int n_samples, int n_theta, int n_data,
                 const int* __restrict__ itab, const float* __restrict__ ftab, int m,
                 int n_data_ops, int n_train_ops, int n_ckpt, int n_variants,
                 int n_f0_rows, int lowest, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x;
  const long b = static_cast<long>(blockIdx.x) * tb + lane;
  if (b >= n_samples) return;  // ragged last block; no barriers follow
  const int dim = 1 << m;
  auto slot = [&](int k) {
    float* base = smem + static_cast<long>(k) * 2 * dim * tb + lane;
    return Col{base, base + dim * tb, tb};
  };
  const Col d = slot(0), t = slot(1), chi = slot(2), v = slot(3);

  const int* data_ops = itab;
  const int* train_ops = data_ops + n_data_ops * kOpFields;
  const int* ckpt = train_ops + n_train_ops * kOpFields;
  const int* var = ckpt + n_train_ops;
  const int* f0_rows = var + n_variants * kVarFields;
  const float* data_consts = ftab;
  const float* train_consts = data_consts + n_data_ops;
  const float* shifts = train_consts + n_train_ops;
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;

  // 1. data register: one theta-independent pass.
  zero_state(d, dim);
  for (int k = 0; k < n_data_ops; ++k) {
    apply_op(data_ops + k * kOpFields, data_consts[k], d, m, th, dt, 0.f, false);
  }
  // 2. forward pass with base angles, checkpointing before first gates.
  zero_state(t, dim);
  for (int k = 0; k < n_train_ops; ++k) {
    if (ckpt[k] >= 0) copy_state(slot(4 + ckpt[k]), t, dim);
    apply_op(train_ops + k * kOpFields, train_consts[k], t, m, th, dt, 0.f, false);
  }
  // 3. base fidelity: group 0 and every shift of an unused parameter.
  const float f0 = inner_fidelity(d, t, dim);
  for (int r = 0; r < n_f0_rows; ++r) out[f0_rows[r] * static_cast<long>(n_samples) + b] = f0;

  // 4. backward walk of chi; variants arrive in descending anchor order.
  copy_state(chi, d, dim);
  int vi = 0;
  for (int k = n_train_ops - 1; k >= lowest; --k) {
    for (; vi < n_variants && var[vi * kVarFields + 4] == k; ++vi) {
      const int* vr = var + vi * kVarFields;
      const int row = vr[0], j = vr[1], first = vr[2], last = vr[3];
      copy_state(v, slot(4 + ckpt[first]), dim);
      for (int kk = first; kk <= last; ++kk) {
        const int* op = train_ops + kk * kOpFields;
        const float delta = (op[4] == kTheta && op[5] == j) ? shifts[vi] : 0.f;
        apply_op(op, train_consts[kk], v, m, th, dt, delta, false);
      }
      out[row * static_cast<long>(n_samples) + b] = inner_fidelity(chi, v, dim);
    }
    if (k > lowest) {
      apply_op(train_ops + k * kOpFields, train_consts[k], chi, m, th, dt, 0.f, true);
    }
  }
}

}  // namespace vqc

extern "C" int vqc_shiftbank_launch(const float* theta, const float* data, int n_samples,
                                    int n_theta, int n_data, const int* itab,
                                    const float* ftab, int m, int n_data_ops,
                                    int n_train_ops, int n_ckpt, int n_variants,
                                    int n_f0_rows, int lowest, float* out, int tb,
                                    int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shiftbank_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + tb - 1) / tb);
  vqc::shiftbank_kernel<<<grid, tb, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops,
      n_ckpt, n_variants, n_f0_rows, lowest, out);
  return static_cast<int>(cudaGetLastError());
}
