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
//   shift_tile_kernel, one WARP per sample, ONE launch for every tile,
//     deepest first: load the tile's boundary into the boundary buffer,
//     advance it through the tile re-deriving the tile's checkpoints, then
//     walk chi from hi - 1 down to lo, replaying every variant anchored at
//     each op from its checkpoint.  chi stays in shared memory from one
//     tile to the next.  Shared memory: the plan tables, staged once per
//     block, then per sample the boundary buffer, chi, one variant and the
//     fullest tile's checkpoints, (n_ckpt + 3) * 2 * 4 * 2^m bytes.  The
//     next boundary is loaded when its tile starts (no prefetch): a
//     boundary is 2 * 4 * 2^m bytes against tens of gate applications of
//     compute per tile.
//
// Per lane the gates apply in the same order as the single sweep
// (vqc_shiftbank.cu), with the same gate formulas (apply_op, warp_apply).
//
// Bound on an H100: per sample the pair moves (P + D) angles twice, the
// data state and n_tiles boundaries out and back in, 2 * (n_tiles + 1)
// states of 2 * 4 * 2^m bytes in all, plus one float per row; the float32
// arithmetic of the gate applications (the recompute pass included) is
// larger at these widths, so arithmetic bounds it.
//
// The tile kernel's design against the limits of the one-thread-per-sample
// kernel it replaced: that kernel gave each sample one thread that walked
// the state serially through shared memory (2^(m-1) dependent steps a
// gate), recomputed cosf/sinf of every base angle at every application,
// and, in blocks of at most 32 samples (the checkpoints' shared memory),
// left one warp on each of 18 SMs at 13q-3l (576 samples), spilling some
// 200 bytes around its __noinline__ apply_op calls.  Here:
//   - a warp owns a sample: each gate is one 32-wide pass (one amplitude
//     pair a lane at m = 6), each checkpoint copy and inner product is
//     32-wide, the latter ending in a warp reduction;
//   - blocks hold SpillTiling.launch_tb samples (4), not the footprint
//     model's 32: 576 samples make 144 blocks that reach every SM;
//   - every state is the warp's slot in shared memory, slot k of warp w at
//     (k * warps + w) * 2 * 2^m floats past the tables, so lane l touches
//     bank l;
//   - the walk is a chain of dependent steps at one or two warps a
//     scheduler, so what each step waits for bounds it: the plan tables
//     are staged in shared memory (a global load on each step's path cost
//     a round trip to L2), each train op's base cos/sin is computed once
//     per sample, lane k holding ops k and k + 32 in registers, and
//     broadcast with __shfl_sync to the recompute pass, the chi walk
//     (inverted: g(t)^dagger = g(-t), cos even, sin odd) and the replays,
//     and each variant's shifted cos/sin likewise (variant k in lane k);
//     ops and variants past the 64th compute theirs where they apply;
//   - a variant whose parameter drives one gate (every variant of an
//     untied circuit) applies it and takes the inner product in one pass
//     (warp_apply_inner): no copy of the checkpoint, no store;
//   - the gate code is inlined (no call, no spills).
// The boundaries and the chi seed stay in the forward kernel's layout
// [tile][re/im][amp][sample]: a warp reads a state as 2 * 2^m words that
// lie n_samples apart, a sector each, about 7 MB of sectors at 576 samples
// and 3 states (a few microseconds, through L2 shared with the
// neighbouring warps), while the forward kernel, one thread per sample,
// writes that layout coalesced.
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

// One warp per sample, blockDim.x / 32 samples a block (SpillTiling's
// launch_tb).  Shared memory: the staged plan tables, then each sample's
// (n_ckpt + 3) states.
__global__ void __launch_bounds__(1024)
shift_tile_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                  int n_samples, int n_theta, int n_data, const int* __restrict__ itab,
                  const float* __restrict__ ftab, int m, int n_data_ops, int n_train_ops,
                  int n_tiles, int n_variants, const float* __restrict__ chi_in,
                  const float* __restrict__ bnd, float* __restrict__ out) {
  extern __shared__ float smem_all[];
  // Every step of the walk reads the tables: from shared memory they cost
  // a shared-memory load on the step's path instead of a global one.
  // The int table up to the variants' end and every float, rounded up to
  // 32 words (spill_table_bytes in vqc_statevector.py).
  const int n_ints = (n_data_ops + n_train_ops) * kOpFields + 2 * n_train_ops +
                     n_tiles * kTileFields + n_variants * kVarFields;
  const int n_floats = n_data_ops + n_train_ops + n_variants;
  int* itab_s = reinterpret_cast<int*>(smem_all);
  float* ftab_s = smem_all + n_ints;
  for (int i = threadIdx.x; i < n_ints; i += blockDim.x) itab_s[i] = itab[i];
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) ftab_s[i] = ftab[i];
  __syncthreads();  // the block's only barrier, before any warp leaves
  float* smem = smem_all + ((n_ints + n_floats + 31) & ~31);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tb = blockDim.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * tb + warp;
  // warp-uniform (a warp is one sample): the ragged last block's idle warps
  // leave before any shuffle
  if (b >= n_samples) return;
  const int dim = 1 << m;
  const long n = n_samples;
  auto slot = [&](int k) {
    float* base = smem + (static_cast<long>(k) * tb + warp) * 2 * dim;
    return WarpState{base, base + dim};
  };
  // boundary buffer (also the running state), chi, variant, checkpoints
  const WarpState run = slot(0), chi = slot(1), v = slot(2);
  const SpillTables tab(itab_s, ftab_s, n_data_ops, n_train_ops, n_tiles, n_variants);
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;

  // base cos/sin of train ops lane and lane + 32, and the shifted cos/sin
  // of variants lane and lane + 32 (theta[j] + shift: the angle of every
  // gate of parameter j in that variant's replay)
  float c_lo = 0.f, s_lo = 0.f, c_hi = 0.f, s_hi = 0.f;
  if (lane < n_train_ops) {
    op_angle(tab.train_ops + lane * kOpFields, tab.train_consts[lane], th, dt, 0.f, c_lo, s_lo);
  }
  if (lane + 32 < n_train_ops) {
    op_angle(tab.train_ops + (lane + 32) * kOpFields, tab.train_consts[lane + 32], th, dt, 0.f,
             c_hi, s_hi);
  }
  float vc_lo = 0.f, vs_lo = 0.f, vc_hi = 0.f, vs_hi = 0.f;
  if (lane < n_variants) {
    const float ang = th[tab.var[lane * kVarFields + 1]] + tab.shifts[lane];
    vc_lo = cosf(ang / 2.f);
    vs_lo = sinf(ang / 2.f);
  }
  if (lane + 32 < n_variants) {
    const float ang = th[tab.var[(lane + 32) * kVarFields + 1]] + tab.shifts[lane + 32];
    vc_hi = cosf(ang / 2.f);
    vs_hi = sinf(ang / 2.f);
  }
  // k and var are the same on every lane
  auto base_angle = [&](int k, float& c, float& sn) {
    if (k < 64) {
      c = __shfl_sync(kFullMask, k < 32 ? c_lo : c_hi, k & 31);
      sn = __shfl_sync(kFullMask, k < 32 ? s_lo : s_hi, k & 31);
    } else {
      op_angle(tab.train_ops + k * kOpFields, tab.train_consts[k], th, dt, 0.f, c, sn);
    }
  };
  auto shifted_angle = [&](int var, const int* op, float cval, float& c, float& sn) {
    if (var < 64) {
      c = __shfl_sync(kFullMask, var < 32 ? vc_lo : vc_hi, var & 31);
      sn = __shfl_sync(kFullMask, var < 32 ? vs_lo : vs_hi, var & 31);
    } else {
      op_angle(op, cval, th, dt, tab.shifts[var], c, sn);
    }
  };

  warp_load(chi, chi_in, dim, n, b, lane);
  int vi = 0;
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int* tile = tab.tiles + ti * kTileFields;
    const int lo = tile[0], hi = tile[1], last = tile[2];
    // re-derive this tile's checkpoints from its boundary prefix state
    warp_load(run, bnd + static_cast<long>(tile[3]) * 2 * dim * n, dim, n, b, lane);
    for (int k = lo; k <= last; ++k) {
      if (tab.ckpt[k] >= 0) warp_copy(slot(3 + tab.ckpt[k]), run, dim, lane);
      if (k < last) {
        float c, sn;
        base_angle(k, c, sn);
        warp_apply(tab.train_ops + k * kOpFields, c, sn, run, m, lane);
      }
    }
    // chi walk and suffix replays, the single sweep's order; chi at lo
    // seeds the next (shallower) tile.
    for (int k = hi - 1; k >= lo; --k) {
      for (; vi < n_variants && tab.var[vi * kVarFields + 4] == k; ++vi) {
        const int* vr = tab.var + vi * kVarFields;
        const int row = vr[0], j = vr[1], first = vr[2], vlast = vr[3];
        float f;
        if (first == vlast) {  // one gate, parameter j's: fused with the inner product
          const int* op = tab.train_ops + first * kOpFields;
          float c, sn;
          shifted_angle(vi, op, tab.train_consts[first], c, sn);
          f = warp_apply_inner(op, c, sn, slot(3 + tab.ckpt[first]), chi, m, lane);
        } else {
          warp_copy(v, slot(3 + tab.ckpt[first]), dim, lane);
          for (int kk = first; kk <= vlast; ++kk) {
            const int* op = tab.train_ops + kk * kOpFields;
            float c, sn;
            if (op[4] == kTheta && op[5] == j && tab.shifts[vi] != 0.f) {
              shifted_angle(vi, op, tab.train_consts[kk], c, sn);
            } else {
              base_angle(kk, c, sn);
            }
            warp_apply(op, c, sn, v, m, lane);
          }
          f = warp_inner(chi, v, dim, lane);
        }
        if (lane == 0) out[row * n + b] = f;
      }
      if (k > lo || ti + 1 < n_tiles) {
        float c, sn;  // g(t)^dagger = g(-t): cos even, sin odd
        base_angle(k, c, sn);
        warp_apply(tab.train_ops + k * kOpFields, c, -sn, chi, m, lane);
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
  vqc::shift_tile_kernel<<<grid, tb * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops, n_tiles,
      n_variants, chi_in, bnd, out);
  return static_cast<int>(cudaGetLastError());
}
