// Storage sweeps of the fused scoring steps, for sm_90a.
//
// Replaces seven Pallas TPU kernels of pyconsensus_tpu/ops/pallas_kernels.py:
//   apply_weighted_cov        (:468; _apply_cov_kernel :424,
//                              _cov_panel_contribution :398)
//       y = (X - mu)^T (rep * ((X - mu) v))
//   storage_matvec            (:538; _matvec_kernel :511)
//       t = filled(X) v, uncentered: the row pass with m = 0
//   storage_matmat            (:720; _matmat_kernel :665)
//       T = filled(X) V for an (E, k) block, uncentered: the block row
//       pass with m = 0, one launch per group of at most 8 columns
//   scores_dirfix_pass        (:1056; _scores_dirfix_kernel :1024)
//       t = filled(X) loading, then [q; o; c] = [t; rep; 1]^T filled(X)
//   apply_weighted_cov_block  (:853; _cov_block_kernel :754)
//       T = (X - 1 mu^T) V for an (E, k) block, then
//       Y = (X - 1 mu^T)^T (rep * T), k = 1..8
//   storage_rows_matmat       (:978; _rows_matmat_kernel :935)
//       W filled(X) for a (k, R) stack of row vectors, k = 1..8 a launch
//   fill_stats_pass           (:627; _fill_stats_kernel :595)
//       tw = rep^T [present], numer = rep^T (value, 0 where absent)
//
// Design. On the TPU one sequential grid walks row panels and carries the
// (E,) or (k, E) result across them in VMEM, so X is read once per sweep.
// Hopper blocks run in no order and carry nothing between them, so each
// contraction is a pass of its own that shares one decode:
//   (a) row pass: t_i = sum_e xc_ie v_e, one block per 8 rows, a
//       fixed-order block sum per row. The block form takes V transposed,
//       (k, E), so every load is contiguous, and keeps 8 x k sums a
//       thread; a block reduces them warp by warp in a fixed order.
//   (b) column pass: out_ke = sum_i w_ki xc_ie for k = 1..8 weight rows
//       (w = rep * t for a covariance, [t, rep, 1] for the scores, the
//       caller's W for rows_matmat), run as (row chunk x column tile)
//       blocks into [n_chunks, k, E] partials, then a fixed-order reduce
//       over the chunks. The fill statistics are a column pass of their
//       own with two sums per column. No float atomics anywhere.
// xc is decoded in registers: int8 x * 0.5 with x < 0 absent, float with
// NaN absent; with a fill vector an absent entry takes a_e (fill - mu for
// the covariance, fill for the uncentered products), otherwise val - m_e.
//
// Bound. Every kernel here is bound by bytes: one read of X is
// R*E*itemsize (1.0 GB at 10000 x 100000 int8, ~0.30 ms at 3.35 TB/s).
// At k = 5 the block covariance also does 4kRE = 2e10 float32 operations,
// another ~0.30 ms at 67 TFLOP/s. This simple form reads X twice per
// covariance application (row pass, then column pass), so it cannot beat
// twice the byte bound; the one-read fusion is later work. The
// uncentered products read X once: storage_matvec is bound by bytes, and
// storage_matmat at k = 12 by float32 operations (2kRE = 2.4e10, 0.36 ms)
// just above its bytes. Each of their output columns is a sum of its own,
// taken in the same order at any k, so splitting a block into launches
// of at most 8 changes no bit.

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

// n consecutive floats into registers: one 16-byte load for n = 4 (the
// caller keeps the address 16-byte aligned), scalar loads otherwise
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = p[j];
  }
}

// T[c, i] = sum_e xc[i, e] * vt[c, e] for c < K, 8 rows per block. A
// thread keeps the 8 rows' VW-wide loads packed and decodes them SUB
// columns at a time against the matching SUB columns of all K rows of vt,
// so its registers hold 8*K sums, K*SUB weights and the packed rows.
template <typename T, int VW, bool FILL, int K>
__global__ void __launch_bounds__(kRowThreads)
row_block_kernel(const T* __restrict__ x, long long R, long long E,
                 const float* __restrict__ m, const float* __restrict__ a,
                 const float* __restrict__ vt, float* __restrict__ t) {
  constexpr int SUB = VW < 4 ? VW : 4;
  constexpr int NS = kRowsPerBlock * K;
  constexpr int kWarps = kRowThreads / 32;
  __shared__ float scratch[kWarps * NS];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  float acc[kRowsPerBlock][K];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) acc[r][c] = 0.f;
  for (long long e = static_cast<long long>(threadIdx.x) * VW; e < E;
       e += static_cast<long long>(kRowThreads) * VW) {
    Vec<T, VW> xv[kRowsPerBlock];
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r)
      if (r0 + r < R) xv[r] = pyc::load_vec<T, VW>(x + (r0 + r) * E + e);
#pragma unroll
    for (int j0 = 0; j0 < VW; j0 += SUB) {
      float mv[SUB], av[SUB], vv[K][SUB];
      load_floats<SUB>(m + e + j0, mv);
      if (FILL) load_floats<SUB>(a + e + j0, av);
#pragma unroll
      for (int c = 0; c < K; ++c)
        load_floats<SUB>(vt + c * E + e + j0, vv[c]);
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        if (r0 + r < R) {
#pragma unroll
          for (int j = 0; j < SUB; ++j) {
            float val;
            bool absent;
            pyc::decode(xv[r].v[j0 + j], val, absent);
            const float xc = (FILL && absent) ? av[j] : val - mv[j];
#pragma unroll
            for (int c = 0; c < K; ++c) acc[r][c] += xc * vv[c][j];
          }
        }
      }
    }
  }
  // fixed-order block reduction of all 8*K sums: a shuffle tree in each
  // warp, then one thread per sum adds the warp partials in warp order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) scratch[warp * NS + r * K + c] = v;
    }
  __syncthreads();
  if (threadIdx.x < NS) {
    const int r = threadIdx.x / K;
    const int c = threadIdx.x % K;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[w * NS + threadIdx.x];
    if (r0 + r < R) t[c * R + r0 + r] = s;
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

// One column-pass term of the fill statistics. int8 takes the select-free
// decode of _fill_stats_kernel: the sentinel -1 decodes to -0.5, so
// 1 + 2 min(val, 0) is an exact {0, 1} presence weight and max(val, 0) the
// zeroed value.
__device__ __forceinline__ void fill_term(int8_t s, float rw, float& tw,
                                          float& nu) {
  float val = static_cast<float>(s) * 0.5f;
  const float w = (1.f + 2.f * fminf(val, 0.f)) * rw;
  val = fmaxf(val, 0.f);
  tw += w;
  nu += val * w;
}

__device__ __forceinline__ void fill_term(float s, float rw, float& tw,
                                          float& nu) {
  const bool absent = isnan(s);
  const float w = absent ? 0.f : rw;
  tw += w;
  nu += (absent ? 0.f : s) * w;
}

// partial[chunk, 0, e] = sum over the chunk's rows of rep_i [present],
// partial[chunk, 1, e] = sum of rep_i * value (0 where absent)
template <typename T, int VW>
__global__ void __launch_bounds__(kColThreads)
fill_stats_kernel(const T* __restrict__ x, long long R, long long E,
                  const float* __restrict__ rep, long long rows_per_chunk,
                  float* __restrict__ partial) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x) * VW;
  if (e >= E) return;
  const long long chunk = blockIdx.y;
  const long long r0 = chunk * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > R) r1 = R;
  float tw[VW], nu[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) tw[j] = nu[j] = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const Vec<T, VW> xv = pyc::load_vec<T, VW>(x + r * E + e);
    const float rw = rep[r];
#pragma unroll
    for (int j = 0; j < VW; ++j) fill_term(xv.v[j], rw, tw[j], nu[j]);
  }
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    partial[(chunk * 2) * E + e + j] = tw[j];
    partial[(chunk * 2 + 1) * E + e + j] = nu[j];
  }
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

int reduce_chunks(const float* partial, long long n_chunks, long long n,
                  float* out, cudaStream_t s) {
  reduce_chunks_kernel<<<static_cast<unsigned>((n + kReduceThreads - 1) /
                                               kReduceThreads),
                         kReduceThreads, 0, s>>>(partial, n_chunks, n, out);
  return static_cast<int>(cudaGetLastError());
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

// int8 loads 16 columns a thread up to K = 4 and 8 beyond, so that the
// K x VW sums stay within 64 registers
template <typename T, int K>
void launch_col_vw(const T* x, long long R, long long E, const float* m,
                   const float* a, const float* w, long long n_chunks,
                   float* partial, cudaStream_t s) {
  constexpr int VW = (sizeof(T) == 1 && K > 4) ? 8 : 16 / sizeof(T);
  if (E % VW == 0 && pyc::aligned16(x))
    launch_col<T, VW, K>(x, R, E, m, a, w, n_chunks, partial, s);
  else
    launch_col<T, 1, K>(x, R, E, m, a, w, n_chunks, partial, s);
}

template <typename T>
int col_pass(const T* x, long long R, long long E, const float* m,
             const float* a, const float* w, int k, long long n_chunks,
             float* partial, float* out, cudaStream_t s) {
  switch (k) {
    case 1: launch_col_vw<T, 1>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 2: launch_col_vw<T, 2>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 3: launch_col_vw<T, 3>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 4: launch_col_vw<T, 4>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 5: launch_col_vw<T, 5>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 6: launch_col_vw<T, 6>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 7: launch_col_vw<T, 7>(x, R, E, m, a, w, n_chunks, partial, s); break;
    case 8: launch_col_vw<T, 8>(x, R, E, m, a, w, n_chunks, partial, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return reduce_chunks(partial, n_chunks, static_cast<long long>(k) * E, out,
                       s);
}

template <typename T, int VW, bool FILL, int K>
void launch_row_block(const T* x, long long R, long long E, const float* m,
                      const float* a, const float* vt, float* t,
                      cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  row_block_kernel<T, VW, FILL, K><<<grid, kRowThreads, 0, s>>>(x, R, E, m,
                                                                 a, vt, t);
}

template <typename T, int K>
void launch_row_block_vw(const T* x, long long R, long long E,
                         const float* m, const float* a, const float* vt,
                         float* t, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (E % VW == 0 && pyc::aligned16(x)) {
    if (a != nullptr)
      launch_row_block<T, VW, true, K>(x, R, E, m, a, vt, t, s);
    else
      launch_row_block<T, VW, false, K>(x, R, E, m, a, vt, t, s);
  } else {
    if (a != nullptr)
      launch_row_block<T, 1, true, K>(x, R, E, m, a, vt, t, s);
    else
      launch_row_block<T, 1, false, K>(x, R, E, m, a, vt, t, s);
  }
}

template <typename T>
int row_block_pass(const T* x, long long R, long long E, const float* m,
                   const float* a, const float* vt, int k, float* t,
                   cudaStream_t s) {
  switch (k) {
    case 1: launch_row_block_vw<T, 1>(x, R, E, m, a, vt, t, s); break;
    case 2: launch_row_block_vw<T, 2>(x, R, E, m, a, vt, t, s); break;
    case 3: launch_row_block_vw<T, 3>(x, R, E, m, a, vt, t, s); break;
    case 4: launch_row_block_vw<T, 4>(x, R, E, m, a, vt, t, s); break;
    case 5: launch_row_block_vw<T, 5>(x, R, E, m, a, vt, t, s); break;
    case 6: launch_row_block_vw<T, 6>(x, R, E, m, a, vt, t, s); break;
    case 7: launch_row_block_vw<T, 7>(x, R, E, m, a, vt, t, s); break;
    case 8: launch_row_block_vw<T, 8>(x, R, E, m, a, vt, t, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fill_stats(const T* x, long long R, long long E, const float* rep,
               long long n_chunks, float* partial, float* out,
               cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const long long rows_per_chunk = (R + n_chunks - 1) / n_chunks;
  if (E % VW == 0 && pyc::aligned16(x)) {
    const long long per_block = static_cast<long long>(kColThreads) * VW;
    dim3 grid(static_cast<unsigned>((E + per_block - 1) / per_block),
              static_cast<unsigned>(n_chunks));
    fill_stats_kernel<T, VW><<<grid, kColThreads, 0, s>>>(
        x, R, E, rep, rows_per_chunk, partial);
  } else {
    dim3 grid(static_cast<unsigned>((E + kColThreads - 1) / kColThreads),
              static_cast<unsigned>(n_chunks));
    fill_stats_kernel<T, 1><<<grid, kColThreads, 0, s>>>(
        x, R, E, rep, rows_per_chunk, partial);
  }
  return reduce_chunks(partial, n_chunks, 2 * E, out, s);
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

// out[k, e] = sum_i w[k, i] * xc[i, e] for k in 1..8, through
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

// t[c, i] = sum_e xc[i, e] * vt[c, e] for c < k, k in 1..8; vt is (k, E)
// and t (k, R).
int pyc_row_block_pass(const void* x, int is_int8, long long R, long long E,
                       const float* m, const float* a, const float* vt, int k,
                       float* t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return row_block_pass(static_cast<const int8_t*>(x), R, E, m, a, vt, k,
                          t, s);
  return row_block_pass(static_cast<const float*>(x), R, E, m, a, vt, k, t,
                        s);
}

// out[0, e] = sum_i rep_i [present], out[1, e] = sum_i rep_i value_ie,
// through partial[n_chunks, 2, E] and a fixed-order reduce.
int pyc_fill_stats(const void* x, int is_int8, long long R, long long E,
                   const float* rep, long long n_chunks, float* partial,
                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks < 1 || n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_int8)
    return fill_stats(static_cast<const int8_t*>(x), R, E, rep, n_chunks,
                      partial, out, s);
  return fill_stats(static_cast<const float*>(x), R, E, rep, n_chunks,
                    partial, out, s);
}

}  // extern "C"
