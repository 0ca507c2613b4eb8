// Fused outcome resolution, certainty and participation, for sm_90a.
//
// Replaces the Pallas TPU kernel resolve_certainty_fused
// (pyconsensus_tpu/ops/pallas_kernels.py:1275; _resolve_certainty_kernel
// :1117): per column the present-weighted mean (falling back to the
// full-reputation filled mean where no reputation is present), the
// catch-snapped outcome, the certainty (reputation mass agreeing with the
// outcome) and pcol = rep^T [absent] clamped to [0, sum(rep)]; per row
// prow = [absent] . certainty and the absent count.
//
// Design. Outcomes are column reductions and certainty needs the outcome,
// so a column block must walk its columns twice. One block owns C columns
// and stages the whole R x C panel in shared memory (R = 10000 int8 at
// C = 16 is 160 KB of the 227 KB), then walks it twice from there: first
// numer and tw (means, raw, outcomes), then certainty. X is read from
// device memory once for the column half.
//   - Staging: each thread copies whole panel rows (16 bytes when the
//     panel row is 16 bytes wide and aligned), kStageUnroll rows in
//     flight, since the rows are E apart and each load waits on memory.
//   - Walks: a thread reads CW = min(C, 16 / sizeof(T)) neighbouring
//     columns of one panel row in one shared-memory load and keeps CW
//     running sums; thread tid covers column group tid % NG (NG = C / CW)
//     and rows tid / NG, tid / NG + G, ... (G = threads / NG).
//   - Block sums: a fixed shuffle tree over the lanes of one column group,
//     then the warp partials summed in warp order by one thread per
//     column. Nothing depends on scheduling, so the result is the same
//     from run to run.
// The row half is a second kernel, one block per 8 rows, that reads only
// the absence of X and sums each row in a fixed order; no row result
// crosses blocks, and nothing uses float atomics. Columns past E (the
// ragged last block) are staged as zeros and never written.
//
// Bound. Bytes: one read of X is R*E*itemsize (1.0 GB at 10000 x 100000
// int8, ~0.30 ms at 3.35 TB/s). This form reads X twice (column panels,
// then the absence-only row pass).

#include "sweep_common.cuh"

namespace {

using pyc::Vec;

constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
constexpr int kMaxCols = 32;
constexpr int kStageUnroll = 8;
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = 8;

// Dynamic shared memory after the panel: two rows of warp partials per
// column and the block's outcome and fill columns (floats).
constexpr int kAuxFloats = 2 * kResWarps * kMaxCols + 2 * kMaxCols;

// Sum v[j] over the lanes of the warp that share this lane's column group
// (lanes l, l + NG, l + 2 NG, ...). The result is valid in lanes < NG.
template <int CW, int NG>
__device__ __forceinline__ void group_sum(float (&v)[CW]) {
#pragma unroll
  for (int o = 16; o >= NG; o >>= 1)
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
}

template <typename T, int C>
__global__ void __launch_bounds__(kResThreads)
resolve_cols_kernel(const T* __restrict__ x, long long R, long long E,
                    long long panel_bytes, bool vec16,
                    const float* __restrict__ rep,
                    const float* __restrict__ fill,
                    const float* __restrict__ scal, float lo, float hi,
                    float* __restrict__ raw, float* __restrict__ out,
                    float* __restrict__ cert, float* __restrict__ pcol) {
  constexpr int VW = 16 / static_cast<int>(sizeof(T));
  constexpr int CW = C < VW ? C : VW;
  constexpr int NG = C / CW;
  constexpr int G = kResThreads / NG;
  static_assert(NG <= 32 && 32 % NG == 0, "column groups per warp");
  extern __shared__ __align__(16) unsigned char smem[];
  T* panel = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + panel_bytes);
  float* outc = red + 2 * kResWarps * kMaxCols;
  float* fillc = outc + kMaxCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long col0 = static_cast<long long>(blockIdx.x) * C;

  // stage the R x C panel
  if (vec16 && col0 + C <= E) {
    uint4* dst = reinterpret_cast<uint4*>(panel);
    for (long long r0 = tid; r0 < R;
         r0 += static_cast<long long>(kResThreads) * kStageUnroll) {
      uint4 v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * kResThreads;
        if (r < R) v[u] = *reinterpret_cast<const uint4*>(x + r * E + col0);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * kResThreads;
        if (r < R) dst[r] = v[u];
      }
    }
  } else {
    const long long n = R * C;
    for (long long idx = tid; idx < n; idx += kResThreads) {
      const long long r = idx / C;
      const long long col = col0 + (idx - r * C);
      panel[idx] = col < E ? x[r * E + col] : T(0);
    }
  }
  __syncthreads();

  const int cg = tid % NG;
  const int g = tid / NG;
  const T* pcol0 = panel + cg * CW;

  // walk 1: present-weighted sums
  float numer[CW], tw[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) numer[j] = tw[j] = 0.f;
  for (long long r = g; r < R; r += G) {
    const Vec<T, CW> pv = *reinterpret_cast<const Vec<T, CW>*>(pcol0 + r * C);
    const float rs = rep[r];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      float val;
      bool absent;
      pyc::decode(pv.v[j], val, absent);
      if (!absent) {
        numer[j] += rs * val;
        tw[j] += rs;
      }
    }
  }
  group_sum<CW, NG>(numer);
  group_sum<CW, NG>(tw);
  if (lane < NG) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      red[(2 * warp) * kMaxCols + cg * CW + j] = numer[j];
      red[(2 * warp + 1) * kMaxCols + cg * CW + j] = tw[j];
    }
  }
  __syncthreads();
  if (tid < C) {
    float n = 0.f, w = 0.f;
    for (int ww = 0; ww < kResWarps; ++ww) {
      n += red[(2 * ww) * kMaxCols + tid];
      w += red[(2 * ww + 1) * kMaxCols + tid];
    }
    const long long col = col0 + tid;
    const float f = col < E ? fill[col] : 0.f;
    const float rep_total = scal[0];
    const float ft = scal[1];
    const float pc = fminf(fmaxf(rep_total - w, 0.f), rep_total);
    const float fmn = __fadd_rn(n, __fmul_rn(f, pc));
    const float full_mean = fmn / (ft == 0.f ? 1.f : ft);
    const float mean = w > 0.f ? n / w : full_mean;
    const float o = mean < lo ? 0.f : (mean > hi ? 1.f : 0.5f);
    outc[tid] = o;
    fillc[tid] = f;
    if (col < E) {
      raw[col] = mean;
      out[col] = o;
      pcol[col] = pc;
    }
  }
  __syncthreads();

  // walk 2: reputation mass agreeing with the outcome
  float oc[CW], fc[CW], ce[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    oc[j] = outc[cg * CW + j];
    fc[j] = fillc[cg * CW + j];
    ce[j] = 0.f;
  }
  for (long long r = g; r < R; r += G) {
    const Vec<T, CW> pv = *reinterpret_cast<const Vec<T, CW>*>(pcol0 + r * C);
    const float rs = rep[r];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      float val;
      bool absent;
      pyc::decode(pv.v[j], val, absent);
      const float xf = absent ? fc[j] : val;
      if (xf == oc[j]) ce[j] += rs;
    }
  }
  group_sum<CW, NG>(ce);
  if (lane < NG) {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      red[(2 * warp) * kMaxCols + cg * CW + j] = ce[j];
  }
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int ww = 0; ww < kResWarps; ++ww) s += red[(2 * ww) * kMaxCols + tid];
    const long long col = col0 + tid;
    if (col < E) cert[col] = s;
  }
}

// prow[i] = sum_e [absent] cert[e]; narow[i] = sum_e [absent]
template <typename T, int VW>
__global__ void __launch_bounds__(kRowThreads)
resolve_rows_kernel(const T* __restrict__ x, long long R, long long E,
                    const float* __restrict__ cert, float* __restrict__ prow,
                    float* __restrict__ narow) {
  __shared__ float scratch[kRowThreads / 32];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  float ap[kRowsPerBlock], an[kRowsPerBlock];
#pragma unroll
  for (int k = 0; k < kRowsPerBlock; ++k) ap[k] = an[k] = 0.f;
  for (long long e = static_cast<long long>(threadIdx.x) * VW; e < E;
       e += static_cast<long long>(kRowThreads) * VW) {
    float cv[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) cv[j] = cert[e + j];
#pragma unroll
    for (int k = 0; k < kRowsPerBlock; ++k) {
      const long long r = r0 + k;
      if (r < R) {
        const Vec<T, VW> xv = pyc::load_vec<T, VW>(x + r * E + e);
        float sp = 0.f, sn = 0.f;
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          float val;
          bool absent;
          pyc::decode(xv.v[j], val, absent);
          if (absent) {
            sp += cv[j];
            sn += 1.f;
          }
        }
        ap[k] += sp;
        an[k] += sn;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerBlock; ++k) {
    const float sp = pyc::block_sum<kRowThreads>(ap[k], scratch);
    const float sn = pyc::block_sum<kRowThreads>(an[k], scratch);
    if (threadIdx.x == 0 && r0 + k < R) {
      prow[r0 + k] = sp;
      narow[r0 + k] = sn;
    }
  }
}

template <typename T, int C>
cudaError_t launch_cols(const T* x, long long R, long long E, long long smem,
                        long long panel_bytes, const float* rep,
                        const float* fill, const float* scal, float lo,
                        float hi, float* raw, float* out, float* cert,
                        float* pcol, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      resolve_cols_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec16 = C * sizeof(T) == 16 && (E * sizeof(T)) % 16 == 0 &&
                     pyc::aligned16(x);
  const unsigned ncol = static_cast<unsigned>((E + C - 1) / C);
  resolve_cols_kernel<T, C><<<ncol, kResThreads, smem, s>>>(
      x, R, E, panel_bytes, vec16, rep, fill, scal, lo, hi, raw, out, cert,
      pcol);
  return cudaGetLastError();
}

template <typename T>
int resolve(const T* x, long long R, long long E, int C, long long smem,
            const float* rep, const float* fill, const float* scal, float lo,
            float hi, float* raw, float* out, float* cert, float* pcol,
            float* prow, float* narow, cudaStream_t s) {
  const long long panel_bytes = (R * C * static_cast<long long>(sizeof(T))
                                 + 15) / 16 * 16;
  if (smem < panel_bytes + kAuxFloats * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (C) {
#define PYC_COLS(CC)                                                        \
  case CC:                                                                  \
    err = launch_cols<T, CC>(x, R, E, smem, panel_bytes, rep, fill, scal,   \
                             lo, hi, raw, out, cert, pcol, s);              \
    break;
    PYC_COLS(1)
    PYC_COLS(2)
    PYC_COLS(4)
    PYC_COLS(8)
    PYC_COLS(16)
    PYC_COLS(32)
#undef PYC_COLS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int VW = 16 / sizeof(T);
  const unsigned nrow =
      static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  if (E % VW == 0 && pyc::aligned16(x))
    resolve_rows_kernel<T, VW><<<nrow, kRowThreads, 0, s>>>(x, R, E, cert,
                                                            prow, narow);
  else
    resolve_rows_kernel<T, 1><<<nrow, kRowThreads, 0, s>>>(x, R, E, cert,
                                                           prow, narow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// C: panel width in {1, 2, 4, 8, 16, 32}; smem: dynamic shared memory of
// one column block (the panel rounded up to 16 bytes, plus kAuxFloats
// floats); scal = [sum(rep), full_total]; lo / hi: the catch band's f32
// bounds 0.5 -/+ (tolerance + atol).
int pyc_resolve_certainty(const void* x, int is_int8, long long R,
                          long long E, int C, long long smem,
                          const float* rep, const float* fill,
                          const float* scal, float lo, float hi, float* raw,
                          float* out, float* cert, float* pcol, float* prow,
                          float* narow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return resolve(static_cast<const int8_t*>(x), R, E, C, smem, rep, fill,
                   scal, lo, hi, raw, out, cert, pcol, prow, narow, s);
  return resolve(static_cast<const float*>(x), R, E, C, smem, rep, fill,
                 scal, lo, hi, raw, out, cert, pcol, prow, narow, s);
}

}  // extern "C"
