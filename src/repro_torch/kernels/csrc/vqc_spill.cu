// Spilled prefix-reuse shift kernels (kernels 4 and 5 of the port).
//
// Replace repro/kernels/vqc_statevector.py::_shift_forward_kernel and
// ::_shift_tile_kernel, the spilled branch of vqc_shift_fidelity, taken
// when the checkpoints of one warp of samples do not fit a block's shared
// memory (m >= 5 with many anchored parameters).  The train-op sequence is
// cut into depth tiles (spill_tiling in vqc_statevector.py):
//
//   shift_forward_kernel, one thread per sample: the data-register pass,
//     then the train forward pass with base angles.  Writes the data state
//     (the seed of chi), the prefix state at each tile's first op (its
//     boundary), and f0 to every row that takes it.  Device-memory layout
//     [tile][re/im][amp][sample], so neighbouring threads write neighbouring
//     words.  Shared memory: the data and running states.
//   shift_tile_kernel, one thread per sample, ONE launch for every tile,
//     deepest first: load the tile's boundary into the boundary buffer,
//     advance it through the tile re-deriving the tile's checkpoints, then
//     walk chi from hi - 1 down to lo, replaying every variant anchored at
//     each op from its checkpoint.  chi stays in shared memory from one
//     tile to the next.  Shared memory: boundary buffer, chi, one variant
//     and the fullest tile's checkpoints, (n_ckpt + 3) * 2 * 4 * 2^m bytes a
//     sample.  The next boundary is loaded when its tile starts (no
//     prefetch): a boundary is 2 * 4 * 2^m bytes against tens of gate
//     applications of compute per tile.
//
// Per lane the gates apply in the same order as the single sweep
// (vqc_shiftbank.cu), through the same apply_op.
//
// Bound on an H100: per sample the pair moves (P + D) angles twice, the
// data state and n_tiles boundaries out and back in, 2 * (n_tiles + 1)
// states of 2 * 4 * 2^m bytes in all, plus one float per row; the float32
// arithmetic of the gate applications (the recompute pass included) is
// larger at these widths, so arithmetic bounds it.  In practice a block of
// 32 samples or fewer (the shared memory of the checkpoints) leaves one
// warp per SM, and shared-memory latency bounds it first.
#include "statevector.cuh"

namespace vqc {

// A variant-table row: output row, param, first, last, anchor.
constexpr int kVarFields = 5;
// A tile-table row: lo, hi, last checkpoint, tile index.
constexpr int kTileFields = 4;

struct SpillTables {
  const int* data_ops;
  const int* train_ops;
  const int* bnd_of;  // per train op: tile whose boundary precedes it, or -1
  const int* ckpt;    // per train op: checkpoint slot within its tile, or -1
  const int* tiles;   // deepest first
  const int* var;     // descending anchor
  const int* f0_rows;
  const float* data_consts;
  const float* train_consts;
  const float* shifts;

  __device__ SpillTables(const int* itab, const float* ftab, int n_data_ops, int n_train_ops,
                         int n_tiles, int n_variants)
      : data_ops(itab),
        train_ops(itab + n_data_ops * kOpFields),
        bnd_of(train_ops + n_train_ops * kOpFields),
        ckpt(bnd_of + n_train_ops),
        tiles(ckpt + n_train_ops),
        var(tiles + n_tiles * kTileFields),
        f0_rows(var + n_variants * kVarFields),
        data_consts(ftab),
        train_consts(ftab + n_data_ops),
        shifts(ftab + n_data_ops + n_train_ops) {}
};

// Column b of a [re/im][amp][sample] state in device memory.
__device__ __forceinline__ void store_state(float* dst, Col s, int dim, long n, long b) {
  for (int a = 0; a < dim; ++a) {
    dst[a * n + b] = s.r(a);
    dst[(dim + a) * n + b] = s.i(a);
  }
}

__device__ __forceinline__ void load_state(Col s, const float* src, int dim, long n, long b) {
  for (int a = 0; a < dim; ++a) {
    s.r(a) = src[a * n + b];
    s.i(a) = src[(dim + a) * n + b];
  }
}

__global__ void __launch_bounds__(1024)
shift_forward_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                     int n_samples, int n_theta, int n_data, const int* __restrict__ itab,
                     const float* __restrict__ ftab, int m, int n_data_ops, int n_train_ops,
                     int n_tiles, int n_variants, int n_f0_rows, float* __restrict__ out,
                     float* __restrict__ d_out, float* __restrict__ bnd_out) {
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x;
  const long b = static_cast<long>(blockIdx.x) * tb + lane;
  if (b >= n_samples) return;  // ragged last block; no barriers follow
  const int dim = 1 << m;
  const long n = n_samples;
  const Col d{smem + lane, smem + dim * tb + lane, tb};
  const Col t{smem + 2 * dim * tb + lane, smem + 3 * dim * tb + lane, tb};
  const SpillTables tab(itab, ftab, n_data_ops, n_train_ops, n_tiles, n_variants);
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;

  zero_state(d, dim);
  for (int k = 0; k < n_data_ops; ++k) {
    apply_op(tab.data_ops + k * kOpFields, tab.data_consts[k], d, m, th, dt, 0.f, false);
  }
  store_state(d_out, d, dim, n, b);
  zero_state(t, dim);
  for (int k = 0; k < n_train_ops; ++k) {
    const int tile = tab.bnd_of[k];
    if (tile >= 0) store_state(bnd_out + static_cast<long>(tile) * 2 * dim * n, t, dim, n, b);
    apply_op(tab.train_ops + k * kOpFields, tab.train_consts[k], t, m, th, dt, 0.f, false);
  }
  const float f0 = inner_fidelity(d, t, dim);
  for (int r = 0; r < n_f0_rows; ++r) out[tab.f0_rows[r] * n + b] = f0;
}

// Blocks never exceed one warp (spill_tiling), so the bound is 32 and the
// compiler may take up to 255 registers a thread (it takes 80, and still
// spills some 200 bytes around the apply_op calls).
__global__ void __launch_bounds__(32)
shift_tile_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                  int n_samples, int n_theta, int n_data, const int* __restrict__ itab,
                  const float* __restrict__ ftab, int m, int n_data_ops, int n_train_ops,
                  int n_tiles, int n_variants, const float* __restrict__ chi_in,
                  const float* __restrict__ bnd, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int lane = threadIdx.x;
  const long b = static_cast<long>(blockIdx.x) * tb + lane;
  if (b >= n_samples) return;  // ragged last block; no barriers follow
  const int dim = 1 << m;
  const long n = n_samples;
  auto slot = [&](int k) {
    float* base = smem + static_cast<long>(k) * 2 * dim * tb + lane;
    return Col{base, base + dim * tb, tb};
  };
  // boundary buffer (also the running state), chi, variant, checkpoints
  const Col run = slot(0), chi = slot(1), v = slot(2);
  const SpillTables tab(itab, ftab, n_data_ops, n_train_ops, n_tiles, n_variants);
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;

  load_state(chi, chi_in, dim, n, b);
  int vi = 0;
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int* tile = tab.tiles + ti * kTileFields;
    const int lo = tile[0], hi = tile[1], last = tile[2];
    // re-derive this tile's checkpoints from its boundary prefix state
    load_state(run, bnd + static_cast<long>(tile[3]) * 2 * dim * n, dim, n, b);
    for (int k = lo; k <= last; ++k) {
      if (tab.ckpt[k] >= 0) copy_state(slot(3 + tab.ckpt[k]), run, dim);
      if (k < last) {
        apply_op(tab.train_ops + k * kOpFields, tab.train_consts[k], run, m, th, dt, 0.f, false);
      }
    }
    // chi walk and suffix replays, the single sweep's order; chi at lo
    // seeds the next (shallower) tile.
    for (int k = hi - 1; k >= lo; --k) {
      for (; vi < n_variants && tab.var[vi * kVarFields + 4] == k; ++vi) {
        const int* vr = tab.var + vi * kVarFields;
        const int row = vr[0], j = vr[1], first = vr[2], vlast = vr[3];
        copy_state(v, slot(3 + tab.ckpt[first]), dim);
        for (int kk = first; kk <= vlast; ++kk) {
          const int* op = tab.train_ops + kk * kOpFields;
          const float delta = (op[4] == kTheta && op[5] == j) ? tab.shifts[vi] : 0.f;
          apply_op(op, tab.train_consts[kk], v, m, th, dt, delta, false);
        }
        out[row * n + b] = inner_fidelity(chi, v, dim);
      }
      if (k > lo || ti + 1 < n_tiles) {
        apply_op(tab.train_ops + k * kOpFields, tab.train_consts[k], chi, m, th, dt, 0.f, true);
      }
    }
  }
}

}  // namespace vqc

extern "C" int vqc_shift_forward_launch(const float* theta, const float* data, int n_samples,
                                        int n_theta, int n_data, const int* itab,
                                        const float* ftab, int m, int n_data_ops,
                                        int n_train_ops, int n_tiles, int n_variants,
                                        int n_f0_rows, float* out, float* d_out, float* bnd_out,
                                        int tb, int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shift_forward_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + tb - 1) / tb);
  vqc::shift_forward_kernel<<<grid, tb, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops, n_tiles,
      n_variants, n_f0_rows, out, d_out, bnd_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_shift_tile_launch(const float* theta, const float* data, int n_samples,
                                     int n_theta, int n_data, const int* itab, const float* ftab,
                                     int m, int n_data_ops, int n_train_ops, int n_tiles,
                                     int n_variants, const float* chi_in, const float* bnd,
                                     float* out, int tb, int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shift_tile_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + tb - 1) / tb);
  vqc::shift_tile_kernel<<<grid, tb, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops, n_tiles,
      n_variants, chi_in, bnd, out);
  return static_cast<int>(cudaGetLastError());
}
