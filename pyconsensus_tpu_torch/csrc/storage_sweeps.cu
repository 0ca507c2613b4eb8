// Storage sweeps of the fused sztorc scoring step, for sm_90a.
//
// Replaces two Pallas TPU kernels of pyconsensus_tpu/ops/pallas_kernels.py:
//   apply_weighted_cov  (:468; _apply_cov_kernel :424,
//                        _cov_panel_contribution :398)
//       y = (X - mu)^T (rep * ((X - mu) v))
//   scores_dirfix_pass  (:1056; _scores_dirfix_kernel :1024)
//       t = filled(X) loading, then [q; o; c] = [t; rep; 1]^T filled(X)
//
// Design. On the TPU one sequential grid walks row panels and carries the
// (E,) result across them in VMEM, so X is read once per sweep. Hopper
// blocks run in no order and carry nothing between them, so each
// contraction is a pass of its own that shares one decode:
//   (a) row pass:   t_i = sum_e xc_ie v_e, one block per 8 rows, a
//       fixed-order block sum per row;
//   (b) column pass: out_ke = sum_i w_ki xc_ie for k = 1 (w = rep * t) or
//       k = 3 (w = [t, rep, 1]), run as (row chunk x column tile) blocks
//       into [n_chunks, k, E] partials, then a fixed-order reduce over the
//       chunks. No float atomics anywhere.
// xc is decoded in registers: int8 x * 0.5 with x < 0 absent, float with
// NaN absent; with a fill vector an absent entry takes a_e (fill - mu for
// the covariance, fill for the uncentered scores), otherwise val - m_e.
//
// Bound. Both kernels are bound by bytes: one read of X is R*E*itemsize
// (1.0 GB at 10000 x 100000 int8, ~0.30 ms at 3.35 TB/s). This simple
// form reads X twice per call (row pass, then column pass), so it cannot
// beat twice that bound; the one-read fusion is later work.

#include "sweep_common.cuh"

namespace {

using pyc::Vec;

constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kColThreads = 128;
constexpr int kReduceThreads = 256;

template <typename T, int VW, bool FILL>
__global__ void __launch_bounds__(kRowThreads)
row_pass_kernel(const T* __restrict__ x, long long R, long long E,
                const float* __restrict__ m, const float* __restrict__ a,
                const float* __restrict__ v, float* __restrict__ t) {
  __shared__ float scratch[kRowThreads / 32];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  float acc[kRowsPerBlock];
#pragma unroll
  for (int k = 0; k < kRowsPerBlock; ++k) acc[k] = 0.f;
  for (long long e = static_cast<long long>(threadIdx.x) * VW; e < E;
       e += static_cast<long long>(kRowThreads) * VW) {
    float mv[VW], av[VW], vv[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      mv[j] = m[e + j];
      av[j] = FILL ? a[e + j] : 0.f;
      vv[j] = v[e + j];
    }
#pragma unroll
    for (int k = 0; k < kRowsPerBlock; ++k) {
      const long long r = r0 + k;
      if (r < R) {
        const Vec<T, VW> xv = pyc::load_vec<T, VW>(x + r * E + e);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          float val;
          bool absent;
          pyc::decode(xv.v[j], val, absent);
          const float xc = (FILL && absent) ? av[j] : val - mv[j];
          s += xc * vv[j];
        }
        acc[k] += s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerBlock; ++k) {
    const float s = pyc::block_sum<kRowThreads>(acc[k], scratch);
    if (threadIdx.x == 0 && r0 + k < R) t[r0 + k] = s;
  }
}

template <typename T, int VW, bool FILL, int K>
__global__ void __launch_bounds__(kColThreads)
col_partial_kernel(const T* __restrict__ x, long long R, long long E,
                   const float* __restrict__ m, const float* __restrict__ a,
                   const float* __restrict__ w, long long rows_per_chunk,
                   float* __restrict__ partial) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x) * VW;
  if (e >= E) return;
  const long long chunk = blockIdx.y;
  const long long r0 = chunk * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > R) r1 = R;
  float mv[VW], av[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    mv[j] = m[e + j];
    av[j] = FILL ? a[e + j] : 0.f;
  }
  float acc[K][VW];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[k][j] = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const Vec<T, VW> xv = pyc::load_vec<T, VW>(x + r * E + e);
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = w[k * R + r];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      float val;
      bool absent;
      pyc::decode(xv.v[j], val, absent);
      const float xc = (FILL && absent) ? av[j] : val - mv[j];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][j] += wk[k] * xc;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VW; ++j)
      partial[(chunk * K + k) * E + e + j] = acc[k][j];
}

// out[i] = sum over chunks c, in order, of partial[c * n + i]
__global__ void __launch_bounds__(kReduceThreads)
reduce_chunks_kernel(const float* __restrict__ partial, long long n_chunks,
                     long long n, float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (long long c = 0; c < n_chunks; ++c) s += partial[c * n + i];
  out[i] = s;
}

template <typename T, int VW>
void launch_row(const T* x, long long R, long long E, const float* m,
                const float* a, const float* v, float* t, cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  if (a != nullptr)
    row_pass_kernel<T, VW, true><<<grid, kRowThreads, 0, s>>>(x, R, E, m, a,
                                                              v, t);
  else
    row_pass_kernel<T, VW, false><<<grid, kRowThreads, 0, s>>>(x, R, E, m, a,
                                                               v, t);
}

template <typename T, int VW, int K>
void launch_col(const T* x, long long R, long long E, const float* m,
                const float* a, const float* w, long long n_chunks,
                float* partial, cudaStream_t s) {
  const long long rows_per_chunk = (R + n_chunks - 1) / n_chunks;
  const long long per_block = static_cast<long long>(kColThreads) * VW;
  dim3 grid(static_cast<unsigned>((E + per_block - 1) / per_block),
            static_cast<unsigned>(n_chunks));
  if (a != nullptr)
    col_partial_kernel<T, VW, true, K><<<grid, kColThreads, 0, s>>>(
        x, R, E, m, a, w, rows_per_chunk, partial);
  else
    col_partial_kernel<T, VW, false, K><<<grid, kColThreads, 0, s>>>(
        x, R, E, m, a, w, rows_per_chunk, partial);
}

template <typename T, int K>
void launch_col_vw(const T* x, long long R, long long E, const float* m,
                   const float* a, const float* w, long long n_chunks,
                   float* partial, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (E % VW == 0 && pyc::aligned16(x))
    launch_col<T, VW, K>(x, R, E, m, a, w, n_chunks, partial, s);
  else
    launch_col<T, 1, K>(x, R, E, m, a, w, n_chunks, partial, s);
}

template <typename T>
int col_pass(const T* x, long long R, long long E, const float* m,
             const float* a, const float* w, int k, long long n_chunks,
             float* partial, float* out, cudaStream_t s) {
  if (k == 1)
    launch_col_vw<T, 1>(x, R, E, m, a, w, n_chunks, partial, s);
  else if (k == 3)
    launch_col_vw<T, 3>(x, R, E, m, a, w, n_chunks, partial, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(k) * E;
  reduce_chunks_kernel<<<static_cast<unsigned>((n + kReduceThreads - 1) /
                                               kReduceThreads),
                         kReduceThreads, 0, s>>>(partial, n_chunks, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int row_pass(const T* x, long long R, long long E, const float* m,
             const float* a, const float* v, float* t, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (E % VW == 0 && pyc::aligned16(x))
    launch_row<T, VW>(x, R, E, m, a, v, t, s);
  else
    launch_row<T, 1>(x, R, E, m, a, v, t, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// t[i] = sum_e xc[i, e] * v[e]; a (absent value per column) may be null.
int pyc_row_pass(const void* x, int is_int8, long long R, long long E,
                 const float* m, const float* a, const float* v, float* t,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return row_pass(static_cast<const int8_t*>(x), R, E, m, a, v, t, s);
  return row_pass(static_cast<const float*>(x), R, E, m, a, v, t, s);
}

// out[k, e] = sum_i w[k, i] * xc[i, e] for k in {1, 3}, through
// partial[n_chunks, k, E] and a fixed-order reduce.
int pyc_col_pass(const void* x, int is_int8, long long R, long long E,
                 const float* m, const float* a, const float* w, int k,
                 long long n_chunks, float* partial, float* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks < 1 || n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_int8)
    return col_pass(static_cast<const int8_t*>(x), R, E, m, a, w, k,
                    n_chunks, partial, out, s);
  return col_pass(static_cast<const float*>(x), R, E, m, a, w, k, n_chunks,
                  partial, out, s);
}

}  // extern "C"
