// Storage sweeps of the fused scoring steps, for sm_90a.
//
// Replaces seven Pallas TPU kernels of pyconsensus_tpu/ops/pallas_kernels.py,
// and the row half of an eighth:
//   apply_weighted_cov        (:468; _apply_cov_kernel :424,
//                              _cov_panel_contribution :398)
//       t = (X - mu) v (the row-tile pass at k = 1, centered), then
//       y = (X - mu)^T (rep * t) (the column-tile pass at k = 1, centered)
//   storage_matvec            (:538; _matvec_kernel :511)
//       t = filled(X) v: the row-tile pass at k = 1, uncentered
//   storage_matmat            (:720; _matmat_kernel :665)
//       T = filled(X) V for an (E, k) block, uncentered: the row-tile
//       pass, one launch per group of at most 16 columns
//   scores_dirfix_pass        (:1056; _scores_dirfix_kernel :1024)
//       t = filled(X) loading (the row-tile pass at k = 1, uncentered),
//       then [q; o; c] = [t; rep; 1]^T filled(X) (the column-tile pass,
//       k = 3)
//   apply_weighted_cov_block  (:853; _cov_block_kernel :754)
//       T = (X - 1 mu^T) V for an (E, k) block (the row-tile pass,
//       centered), then Y = (X - 1 mu^T)^T (rep * T) (the column-tile
//       pass, centered), k = 1..8
//   storage_rows_matmat       (:978; _rows_matmat_kernel :935)
//       W filled(X) for a (k, R) stack of row vectors: the column-tile
//       pass, uncentered, one launch per group of at most 16 rows
//   fill_stats_pass           (:627; _fill_stats_kernel :595)
//       tw = rep^T [present], numer = rep^T (value, 0 where absent)
//   resolve_certainty_fused   (:1275; _resolve_certainty_kernel :1117),
//       its row half: [prow; narow] = [absent] [cert; 1]^T, the row-tile
//       pass at k = 2 with the absent-indicator element op (the column
//       half is csrc/resolve.cu)
//
// Design. On the TPU one sequential grid walks row panels and carries the
// (E,) or (k, E) result across them in VMEM, so X is read once per sweep.
// Hopper blocks run in no order and carry nothing between them, so each
// contraction is a pass of its own that shares one decode:
//   (a) row-tile pass, T[c, i] = sum_e xc_ie V[e, c] for k <= 16 columns:
//       every row contraction, the body of _matmat_kernel and of
//       _matvec_kernel (k = 1) and the row halves of _apply_cov_kernel
//       (k = 1), _scores_dirfix_kernel (k = 1) and _cov_block_kernel, and,
//       with xc the absent indicator, resolve's row half (k = 2). See
//       row_tile_kernel below.
//   (b) column-tile pass, out[c, e] = sum_i W[c, i] xc_ie for k <= 16
//       weight rows: the body of _rows_matmat_kernel :935 and the column
//       halves of _apply_cov_kernel :424 (W = rep * t),
//       _scores_dirfix_kernel :1024 (W = [t; rep; 1]) and
//       _cov_block_kernel :754 (W = (rep * T)^T). See col_tile_kernel
//       below. The fill statistics are a column pass of their own with
//       two sums per column, into per-chunk partials. No float atomics
//       anywhere.
// xc is decoded in registers: int8 x * 0.5 with x < 0 absent, float32 and
// bfloat16 (its bits the high half of a float32, exact) with NaN absent;
// with a fill vector an absent entry takes a_e (fill - mu for
// the covariance, fill for the uncentered products), otherwise val - m_e
// when centered and val when not (the uncentered passes compile the
// centering out and read no mean); under the absent op (resolve's row
// half), xc is 1 where absent and 0 elsewhere, whose sums are exact
// integers below 2^24 in any order.
//
// Bound. One read of X is R*E*itemsize (1.0 GB at 10000 x 100000 int8,
// ~0.30 ms at 3.35 TB/s; 2.0 GB, ~0.60 ms, at bfloat16); the fill
// statistics are bound by it. The two
// tile passes do 2kRE float32 operations: at int8 they are bound by the
// one read of X up to k = 8 (0.30 ms; at k = 1, the matvecs, the
// operations alone would take 0.03 ms) and by the operations above it
// (0.358 ms at k = 12, 0.478 at k = 16, at 67 TFLOP/s), so there the FMA
// pipe and the instructions around it hold them; on bfloat16 (2 GB,
// 0.60 ms) and float32 storage (4 GB, 1.19 ms) by bytes at every k <= 16.
// A covariance application reads X twice
// (row-tile pass, then column-tile pass), so it cannot beat twice the
// byte bound; the one-read fusion is later work.
//
// The row-tile pass. A block owns 64 rows and one of S ranges of E (grid
// (ceil(R / 64), S)); it walks its range in chunks of 512 bytes a row (512
// int8, 256 bfloat16 or 128 float32 columns) and copies each chunk's X
// tile (32 KB), the chunk of V^T as float32 (k x 512 int8 columns) and of fill (and mu) into shared memory once for
// all 64 rows, with 16-byte cp.async copies through a ring of 3 stages,
// so the copy of chunk q + 2 overlaps the FMAs of chunk q (at k = 1, the
// matvecs, two blocks share an SM, and the centered int8 ring has two
// stages so that both fit). A thread sums 8 rows x k columns over 4
// columns of each 128-column slice; a V value it loads from shared memory
// feeds 8 rows, a decoded entry k columns, which keeps shared memory
// under the FMA pipe's pace. The int8 decode
// is integer ops and one FMA, no int-to-float conversion. The S range
// sums go to partials that reduce_chunks_kernel adds in a fixed order;
// S is the fewest ranges whose blocks best fill the last wave of one
// block per SM. Tile, chunk and S depend on R, E, the storage type and
// the card, never on k, so a column's sum is taken in the same order at
// any k, and the group loop of storage_matmat changes no bit. One launch
// takes k <= 16, so k = 12 reads X once.
//
// The column-tile pass is the same tiling turned on its side. A block
// owns a tile of 512 bytes of each row (512 int8, 256 bfloat16 or 128
// float32 columns)
// and one of S ranges of rows (grid (ceil(E / tile), S)); it walks its
// range in chunks of 64 rows, and the same 3-stage cp.async ring brings
// each chunk's X tile (32 KB) and W's chunk as float32 (k x 64) into
// shared memory; the tile's fill and mu go into registers once per
// block. A chunk wholly inside the matrix is copied with no bounds
// checks, a pointer add and a cp.async a granule (the checked copies'
// address arithmetic cost 0.05-0.07 ms a launch, tools/col_tile_lab.py);
// the ragged edges take the row-tile pass's checked helpers. A thread
// owns 4 adjacent columns and sums 4 x k of them over its share of each
// chunk's rows (32 rows at int8, 16 at bfloat16, 8 at float32); per 4 rows it loads each
// W row's 4 values as one float4 that every lane of the warp reads at
// the same address (a broadcast), so a W value feeds 4 columns' FMAs and
// a decoded entry k. The row groups' sums of a column are added in a
// fixed order through shared memory at the end. At most 128 registers a
// thread (k >= 11 spills about 100 bytes) and at most 110.6 KB of shared
// memory a block let two blocks share an SM, so one block's copies and
// barriers hide behind the other's FMAs (one block an SM was 0.04-0.1 ms
// slower a launch at every k); S is
// the fewest row ranges whose blocks best fill the last wave of two
// blocks per SM (196 tiles x 4 = 784 blocks at 10000 x 100000 int8, 2.97
// waves of 264), so the partials are S x k x E floats (19 MB at k = 12)
// and not a fifth of X. Tile, chunk and S never depend on k: rows 0-7 of
// a k = 12 launch equal a k = 8 launch bit for bit, and one launch takes
// k <= 16, so the separable arm's 12 and 13 rows read X once.
//
// Tensor cores are left out. A product faithful to float32 needs V (or
// W) split into three TF32 or bf16 pieces (the TPU kernel's compensated
// bf16 halves, _matmat_kernel), and at k <= 16 the float32-operation
// bound (0.358 ms at k = 12, 0.478 at k = 16) is within 1.6x of the byte
// bound (0.30 ms), so mma/wgmma could win at most about 0.18 ms a launch.

#include <atomic>
#include <utility>

#include "sweep_common.cuh"

namespace {

using pyc::Vec;

constexpr int kColThreads = 128;
constexpr int kReduceThreads = 256;

// Tile geometry of the row-tile kernel. A block owns kTileRows rows and
// walks its share of E in chunks of kTileBytes bytes of each row (512
// int8 or 128 float32 columns); warp w owns rows 8w..8w+7 of the tile, and
// lane l columns 4l..4l+3 of each 128-column slice of a chunk. None of it
// depends on K, so every output column is summed in the same order at any
// k.
constexpr int kTileThreads = 256;
constexpr int kTileRows = 64;
constexpr int kThreadRows = kTileRows / (kTileThreads / 32);
constexpr int kTileBytes = 512;
constexpr int kSliceCols = 128;
constexpr int kStages = 3;
// shared memory of one SM, of which each resident block also takes 1 KB
constexpr int kSmemPerSm = 233472;
// most E ranges (partials) of one row-tile launch
constexpr int kMaxSplits = 16;
// widest block of one launch: uncentered, and centered (the covariance's
// row half)
constexpr int kMaxTileK = 16;
constexpr int kMaxCenteredK = 8;

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return kTileBytes / static_cast<int>(sizeof(T));
}

// bytes of one pipeline stage: the X tile, K rows of vt, fill (or
// fill - mu) and, under CENTER, mu, each for the chunk's columns
template <typename T, bool CENTER, int K>
__host__ __device__ constexpr int stage_bytes() {
  return kTileRows * kTileBytes +
         (K + 1 + (CENTER ? 1 : 0)) * tile_cols<T>() * 4;
}

// Resident blocks and ring stages of one row-tile launch. At k = 1 (the
// matvecs) two blocks share an SM, so one block's copies and barriers hide
// behind the other's sums; their rings must then fit the SM together,
// which three centered int8 stages (116.7 KB a block) do not, so that
// ring takes two. Neither changes the order of any sum, and S still counts
// one block an SM at every k.
template <int K>
__host__ __device__ constexpr int row_blocks_per_sm() {
  return K == 1 ? 2 : 1;
}

template <typename T, bool CENTER, int K>
__host__ __device__ constexpr int row_stages() {
  return row_blocks_per_sm<K>() * (kStages * stage_bytes<T, CENTER, K>() +
                                   1024) <= kSmemPerSm
             ? kStages
             : 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n_rows float rows (row c at src + c * stride) from column e0 on, n
// columns each, into shared memory, zero past E: 16-byte asynchronous
// copies, or one float a thread
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int n_rows,
                                           long long e0, long long E, int n,
                                           bool vec) {
  if (vec) {
    const int per_row = n / 4;
    for (int g = threadIdx.x; g < n_rows * per_row; g += kTileThreads) {
      const int c = g / per_row;
      const int col = 4 * (g % per_row);
      const long long e = e0 + col;
      const bool ok = e < E;
      cp_async16(dst + c * n + col, ok ? src + c * stride + e : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * n; i += kTileThreads) {
      const int c = i / n;
      const long long e = e0 + i % n;
      dst[i] = e < E ? src[c * stride + e] : 0.f;
    }
  }
}

// The X tile of rows r0 .. r0 + 63 and columns e0 .. e0 + tile_cols into
// xs (row-major, tile_cols a row), zero past R and past E. With vec each
// copy is a 16-byte cp.async (every row starts 16-byte aligned);
// otherwise a row start may not be, and each element is copied on its
// own.
template <typename T>
__device__ __forceinline__ void stage_x_tile(T* xs, const T* __restrict__ x,
                                             long long R, long long E,
                                             long long r0, long long e0,
                                             bool vec) {
  constexpr int BK = tile_cols<T>();
  constexpr int GPR = kTileBytes / 16;                 // granules per row
  if (vec) {
    for (int g = threadIdx.x; g < kTileRows * GPR; g += kTileThreads) {
      const int r = g / GPR;
      const int col = (g % GPR) * (16 / static_cast<int>(sizeof(T)));
      const long long row = r0 + r;
      const long long e = e0 + col;
      const bool ok = row < R && e < E;
      cp_async16(xs + r * BK + col, ok ? x + row * E + e : x, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTileRows * BK; i += kTileThreads) {
      const long long row = r0 + i / BK;
      const long long e = e0 + i % BK;
      xs[i] = (row < R && e < E) ? x[row * E + e] : pyc::zero<T>();
    }
  }
}

// One chunk (columns e0 .. e0 + tile_cols) of the X tile, vt, fill and mu
// into a stage, 16-byte copies with vec (rows, vt rows and vectors all
// start 16-byte aligned), element copies otherwise. Columns past E are
// zero: a zero vt column makes them add nothing.
template <typename T, bool CENTER, int K>
__device__ __forceinline__ void stage_chunk(
    unsigned char* st, const T* __restrict__ x, long long R, long long E,
    long long r0, long long e0, const float* __restrict__ m,
    const float* __restrict__ a, const float* __restrict__ vt, bool vec) {
  constexpr int BK = tile_cols<T>();
  float* vs = reinterpret_cast<float*>(st + kTileRows * kTileBytes);
  stage_x_tile(reinterpret_cast<T*>(st), x, R, E, r0, e0, vec);
  stage_rows(vs, vt, E, K, e0, E, BK, vec);
  if (a != nullptr) stage_rows(vs + K * BK, a, 0, 1, e0, E, BK, vec);
  if constexpr (CENTER) stage_rows(vs + (K + 1) * BK, m, 0, 1, e0, E, BK, vec);
}

// Four columns of one row, decoded into xc: the fill value where absent
// (when a fill is given), else val - mu under CENTER, else val.
//
// int8: no int-to-float conversion (a quarter-rate instruction on sm_90).
// Each byte, offset by 128, goes into the low mantissa of 2^23, and one
// FMA takes back 0.5 * (2^23 + s + 128) - (2^22 + 64) = 0.5 * s, exactly.
// The sentinel s < 0 is then val < 0.
__device__ __forceinline__ void decode4(const int8_t* p, float (&val)[4],
                                        bool (&absent)[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    val[j] = fmaf(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j)),
                  0.5f, -4194368.f);
    absent[j] = val[j] < 0.f;
  }
}

// bfloat16: four entries are one 8-byte load; each 16-bit half of a word
// is the high half of its float32 value
__device__ __forceinline__ void decode4(const __nv_bfloat16* p,
                                        float (&val)[4], bool (&absent)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  val[0] = pyc::bf16_bits_to_float(q.x);
  val[1] = __uint_as_float(q.x & 0xFFFF0000u);
  val[2] = pyc::bf16_bits_to_float(q.y);
  val[3] = __uint_as_float(q.y & 0xFFFF0000u);
#pragma unroll
  for (int j = 0; j < 4; ++j) absent[j] = isnan(val[j]);
}

__device__ __forceinline__ void decode4(const float* p, float (&val)[4],
                                        bool (&absent)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  val[0] = q.x;
  val[1] = q.y;
  val[2] = q.z;
  val[3] = q.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) absent[j] = isnan(val[j]);
}

// out[split, c, i] = sum over the split's columns e of xc[i, e] * vt[c, e]
// for c < K and the block's 64 rows (the layout of the partials that
// reduce_chunks_kernel sums; with one split, the (K, R) result itself).
// The chunks of the split pass through a ring of row_stages stages: the
// copies of the next one or two chunks are in flight while chunk q is
// summed. A thread keeps
// 8 x K sums: each vt value it reads from shared memory feeds 8 rows, and
// each decoded entry K columns. The 32 lanes' sums of a row are added in a
// fixed shuffle tree at the end. ABSENT: xc is the absent indicator.
template <typename T, bool CENTER, int K, bool ABSENT = false>
__global__ void __launch_bounds__(kTileThreads, row_blocks_per_sm<K>())
row_tile_kernel(const T* __restrict__ x, long long R, long long E,
                const float* __restrict__ m, const float* __restrict__ a,
                const float* __restrict__ vt, int vec, int n_splits,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BK = tile_cols<T>();
  constexpr int SB = stage_bytes<T, CENTER, K>();
  constexpr int ST = row_stages<T, CENTER, K>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long n_chunks = (E + BK - 1) / BK;
  const long long per_split = (n_chunks + n_splits - 1) / n_splits;
  const long long q0 = blockIdx.y * per_split;
  const long long q1 = q0 + per_split < n_chunks ? q0 + per_split : n_chunks;
  const int n = q1 > q0 ? static_cast<int>(q1 - q0) : 0;
  const bool has_fill = a != nullptr;

  float acc[kThreadRows][K];
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n)
      stage_chunk<T, CENTER, K>(smem + i * SB, x, R, E, r0, (q0 + i) * BK, m,
                                a, vt, vec);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();           // chunk i is in; chunk i - 1 is summed
    const int nx = i + ST - 1;
    if (nx < n)
      stage_chunk<T, CENTER, K>(smem + (nx % ST) * SB, x, R, E, r0,
                                (q0 + nx) * BK, m, a, vt, vec);
    cp_async_commit();
    const unsigned char* st = smem + (i % ST) * SB;
    const T* xs = reinterpret_cast<const T*>(st) + warp * kThreadRows * BK;
    const float* vs =
        reinterpret_cast<const float*>(st + kTileRows * kTileBytes);
    const long long e0 = (q0 + i) * BK;
#pragma unroll 1
    for (int s0 = 0; s0 < BK; s0 += kSliceCols) {
      if (e0 + s0 >= E) break;                  // all zero past E
      const int col = s0 + 4 * lane;
      float fv[4] = {0.f, 0.f, 0.f, 0.f}, mv[4] = {0.f, 0.f, 0.f, 0.f};
      if (has_fill) {
        const float4 q = *reinterpret_cast<const float4*>(vs + K * BK + col);
        fv[0] = q.x; fv[1] = q.y; fv[2] = q.z; fv[3] = q.w;
      }
      if constexpr (CENTER) {
        const float4 q =
            *reinterpret_cast<const float4*>(vs + (K + 1) * BK + col);
        mv[0] = q.x; mv[1] = q.y; mv[2] = q.z; mv[3] = q.w;
      }
      float xc[kThreadRows][4];
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        float val[4];
        bool absent[4];
        decode4(xs + r * BK + col, val, absent);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xc[r][j] = ABSENT ? (absent[j] ? 1.f : 0.f)
                     : (has_fill && absent[j])
                         ? fv[j]
                         : (CENTER ? val[j] - mv[j] : val[j]);
      }
      float4 v[K];
#pragma unroll
      for (int c = 0; c < K; ++c)
        v[c] = *reinterpret_cast<const float4*>(vs + c * BK + col);
      // one 8 x K outer product per column: consecutive FMAs feed
      // different sums, so none waits on the one before
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
          for (int c = 0; c < K; ++c)
            acc[r][c] = fmaf(xc[r][j], (&v[c].x)[j], acc[r][c]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, o);
      acc[r][c] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
      const long long row = r0 + warp * kThreadRows + r;
      if (row < R)
#pragma unroll
        for (int c = 0; c < K; ++c)
          out[(static_cast<long long>(blockIdx.y) * K + c) * R + row] =
              acc[r][c];
    }
  }
}

// Geometry of the column-tile pass: the row-tile pass's X tile (64 rows x
// 512 bytes) walked down the rows. A thread owns 4 adjacent columns of
// the tile: tile_cols / 4 threads span a row (128 at int8, 64 at
// bfloat16, 32 at float32), and the block's 256 threads form row groups
// (2, 4 or 8) that each sum 32, 16 or 8 rows of every chunk. Two blocks
// share an SM.
constexpr int kColTileBlocksPerSm = 2;

template <typename T>
__host__ __device__ constexpr int col_row_groups() {
  return kTileThreads / (tile_cols<T>() / 4);
}

// bytes of one column-tile stage: the X tile and K rows of W's chunk
template <int K>
__host__ __device__ constexpr int col_stage_bytes() {
  return kTileRows * kTileBytes + K * kTileRows * 4;
}

// out[split, c, e] = sum over the split's rows i of w[c, i] * xc[i, e]
// for c < K and the block's tile of columns (the layout of the partials
// that reduce_chunks_kernel sums; with one split, the (K, E) result
// itself). flags: bit 0, the X tile takes 16-byte copies; bit 1, W's
// chunk does. The chunks of the split pass through a ring of kStages
// stages: the copy of chunk q + 2 is in flight while chunk q is summed.
// A thread keeps K x 4 sums, adds its rows in order, and the row groups'
// sums meet in shared memory, added in group order.
template <typename T, bool CENTER, int K>
__global__ void __launch_bounds__(kTileThreads, kColTileBlocksPerSm)
col_tile_kernel(const T* __restrict__ x, long long R, long long E,
                const float* __restrict__ m, const float* __restrict__ a,
                const float* __restrict__ w, int flags, int n_splits,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BK = tile_cols<T>();
  constexpr int CG = BK / 4;                         // threads along a row
  constexpr int RG = col_row_groups<T>();
  constexpr int RPG = kTileRows / RG;                // rows of a group
  constexpr int SB = col_stage_bytes<K>();
  const bool xvec = flags & 1;
  const bool wvec = flags & 2;
  const int grp = threadIdx.x / CG;
  const int col = 4 * (threadIdx.x % CG);
  const long long e0 = static_cast<long long>(blockIdx.x) * BK;
  const long long n_chunks = (R + kTileRows - 1) / kTileRows;
  const long long per_split = (n_chunks + n_splits - 1) / n_splits;
  const long long q0 = blockIdx.y * per_split;
  const long long q1 = q0 + per_split < n_chunks ? q0 + per_split : n_chunks;
  const int n = q1 > q0 ? static_cast<int>(q1 - q0) : 0;
  const bool has_fill = a != nullptr;
  const bool live = e0 + col < E;         // some of the 4 columns is real

  float fv[4], mv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long e = e0 + col + j;
    fv[j] = (has_fill && e < E) ? a[e] : 0.f;
    mv[j] = (CENTER && e < E) ? m[e] : 0.f;
  }
  float acc[K][4];
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

  // The copies of a chunk land where stage_x_tile and stage_rows put
  // them: thread t's granules are t % 32 of tile rows t / 32 + 8j (j < 8),
  // and granule t of W's chunk (K x 16 of them). A chunk wholly inside R,
  // of a tile wholly inside E, takes them with no checks: the source
  // advances by whole rows, so a copy is a pointer add and a cp.async.
  constexpr int GPR = kTileBytes / 16;               // granules per row
  constexpr int RPS = kTileThreads / GPR;            // rows per sweep
  const bool fast = xvec && wvec && e0 + BK <= E;
  const long long sweep = static_cast<long long>(RPS) * E;
  const T* xsrc = x + (q0 * kTileRows + threadIdx.x / GPR) * E + e0 +
                  (threadIdx.x % GPR) * (16 / static_cast<int>(sizeof(T)));
  const bool wcopy = threadIdx.x < K * (kTileRows / 4);
  const float* wsrc =
      w + (wcopy ? (threadIdx.x / (kTileRows / 4)) * R + q0 * kTileRows +
                       4 * (threadIdx.x % (kTileRows / 4))
                 : 0);
  auto stage = [&](int i) {
    unsigned char* st = smem + (i % kStages) * SB;
    const long long r0 = (q0 + i) * kTileRows;
    if (fast && r0 + kTileRows <= R) {
      const T* src = xsrc + static_cast<long long>(i) * kTileRows * E;
      unsigned char* dst = st + threadIdx.x * 16;
#pragma unroll
      for (int j = 0; j < kTileRows / RPS; ++j)
        cp_async16(dst + j * RPS * kTileBytes, src + j * sweep, 16);
      if (wcopy)
        cp_async16(dst + kTileRows * kTileBytes, wsrc + i * kTileRows, 16);
    } else {
      stage_x_tile(reinterpret_cast<T*>(st), x, R, E, r0, e0, xvec);
      stage_rows(reinterpret_cast<float*>(st + kTileRows * kTileBytes), w,
                 R, K, r0, R, kTileRows, wvec);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();           // chunk i is in; chunk i - 1 is summed
    if (i + kStages - 1 < n) stage(i + kStages - 1);
    cp_async_commit();
    if (!live) continue;
    const unsigned char* st = smem + (i % kStages) * SB;
    const T* xs = reinterpret_cast<const T*>(st) + grp * RPG * BK + col;
    const float* ws =
        reinterpret_cast<const float*>(st + kTileRows * kTileBytes) +
        grp * RPG;
#pragma unroll 1
    for (int r = 0; r < RPG; r += 4) {
      float xc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float val[4];
        bool absent[4];
        decode4(xs + (r + j) * BK, val, absent);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xc[j][q] = (has_fill && absent[q])
                         ? fv[q]
                         : (CENTER ? val[q] - mv[q] : val[q]);
      }
      // W[c, r .. r + 3]: one broadcast float4 feeds 4 rows x 4 columns;
      // each sum takes its rows in order
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + c * kTileRows + r);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[c][q] = fmaf(xc[j][q], (&wv.x)[j], acc[c][q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring is free for the group sums

  float* red = reinterpret_cast<float*>(smem);       // [RG][K][BK]
#pragma unroll
  for (int c = 0; c < K; ++c)
    *reinterpret_cast<float4*>(red + (grp * K + c) * BK + col) =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < K * BK; i += kTileThreads) {
    const long long e = e0 + i % BK;
    if (e >= E) continue;
    float s = red[i];
#pragma unroll
    for (int g = 1; g < RG; ++g) s += red[g * K * BK + i];
    out[(static_cast<long long>(blockIdx.y) * K + i / BK) * E + e] = s;
  }
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

// Of 1 .. kMaxSplits ranges (at most one per chunk), the fewest whose
// tiles x ranges blocks fill the last wave of `slots` resident blocks
// best, so that few blocks pay the pipeline's start and the last wave
// leaves few SMs idle.
int wave_splits(long long tiles, long long chunks, long long slots) {
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxSplits && s <= chunks; ++s) {
    const long long blocks = tiles * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = static_cast<double>(blocks) / (waves * slots);
    if (fill > best_fill + 1e-3) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// E ranges of the row-tile pass for an R x E matrix on a card of n_sm
// SMs, one block per SM (10000 rows: 157 tiles x 5 ranges = 5.95 waves
// of 132). A function of R, E, the storage type and the card, never of K.
int row_tile_splits(long long R, long long E, int itemsize, int n_sm) {
  const long long cols = kTileBytes / itemsize;
  return wave_splits((R + kTileRows - 1) / kTileRows, (E + cols - 1) / cols,
                     n_sm);
}

// Row ranges of the column-tile pass, two blocks per SM (100000 int8
// columns: 196 tiles x 4 ranges = 2.97 waves of 264). Never of K.
int col_tile_splits(long long R, long long E, int itemsize, int n_sm) {
  const long long cols = kTileBytes / itemsize;
  return wave_splits((E + cols - 1) / cols, (R + kTileRows - 1) / kTileRows,
                     static_cast<long long>(kColTileBlocksPerSm) * n_sm);
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// device; `opted` holds a bit per device.
template <typename Kernel>
int opt_in_smem(Kernel kernel, int smem,
                std::atomic<unsigned long long>& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  return 0;
}

template <typename T, bool CENTER, int K, bool ABSENT = false>
int launch_row_tile(const T* x, long long R, long long E, const float* m,
                    const float* a, const float* vt, int n_splits,
                    float* out, cudaStream_t s) {
  constexpr int smem =
      row_stages<T, CENTER, K>() * stage_bytes<T, CENTER, K>();
  static_assert(smem <= 232448, "stages exceed a block's shared memory");
  static_assert(row_blocks_per_sm<K>() * (smem + 1024) <= kSmemPerSm,
                "the resident blocks' stages exceed an SM's shared memory");
  static std::atomic<unsigned long long> opted{0};
  const int err =
      opt_in_smem(row_tile_kernel<T, CENTER, K, ABSENT>, smem, opted);
  if (err != 0) return err;
  const bool vec = (E * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   pyc::aligned16(x) && pyc::aligned16(vt) &&
                   (a == nullptr || pyc::aligned16(a)) &&
                   (!CENTER || pyc::aligned16(m));
  dim3 grid(static_cast<unsigned>((R + kTileRows - 1) / kTileRows),
            static_cast<unsigned>(n_splits));
  row_tile_kernel<T, CENTER, K, ABSENT><<<grid, kTileThreads, smem, s>>>(
      x, R, E, m, a, vt, vec ? 1 : 0, n_splits, out);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for k, K = 1 .. sizeof...(Ks)
template <typename T, bool CENTER, int... Ks>
int launch_row_tile_k(int k, std::integer_sequence<int, Ks...>, const T* x,
                      long long R, long long E, const float* m,
                      const float* a, const float* vt, int n_splits,
                      float* out, cudaStream_t s) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((k == Ks + 1 ? (err = launch_row_tile<T, CENTER, Ks + 1>(
                       x, R, E, m, a, vt, n_splits, out, s))
                : 0),
   ...);
  return err;
}

template <typename T>
int row_tile_pass(const T* x, long long R, long long E, const float* m,
                  const float* a, const float* vt, int k, int n_splits,
                  float* partial, float* t, cudaStream_t s) {
  float* out = n_splits > 1 ? partial : t;
  using Centered = std::make_integer_sequence<int, kMaxCenteredK>;
  using Uncentered = std::make_integer_sequence<int, kMaxTileK>;
  const int err =
      m != nullptr
          ? launch_row_tile_k<T, true>(k, Centered(), x, R, E, m, a, vt,
                                       n_splits, out, s)
          : launch_row_tile_k<T, false>(k, Uncentered(), x, R, E, m, a, vt,
                                        n_splits, out, s);
  if (err != 0 || n_splits == 1) return err;
  return reduce_chunks(partial, n_splits, static_cast<long long>(k) * R, t, s);
}

// t[c, i] = sum_e [x_ie absent] vt[c, e] for c < 2: resolve's row half
// (vt = [cert; 1]), the uncentered row-tile pass with the absent op and
// the tile, chunk and S of every other row contraction
template <typename T>
int row_tile_absent(const T* x, long long R, long long E, const float* vt,
                    int n_splits, float* partial, float* t, cudaStream_t s) {
  float* out = n_splits > 1 ? partial : t;
  const int err = launch_row_tile<T, false, 2, true>(x, R, E, nullptr,
                                                     nullptr, vt, n_splits,
                                                     out, s);
  if (err != 0 || n_splits == 1) return err;
  return reduce_chunks(partial, n_splits, 2LL * R, t, s);
}

template <typename T, bool CENTER, int K>
int launch_col_tile(const T* x, long long R, long long E, const float* m,
                    const float* a, const float* w, int n_splits,
                    float* out, cudaStream_t s) {
  constexpr int smem = kStages * col_stage_bytes<K>();
  static_assert(kColTileBlocksPerSm * (smem + 1024) <= kSmemPerSm,
                "two blocks' stages exceed an SM's shared memory");
  static_assert(col_row_groups<T>() * K * tile_cols<T>() * 4 <= smem,
                "the group sums exceed the ring");
  static std::atomic<unsigned long long> opted{0};
  const int err = opt_in_smem(col_tile_kernel<T, CENTER, K>, smem, opted);
  if (err != 0) return err;
  // 16-byte copies of X's rows, and of W's rows
  const bool xvec = (E * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                    pyc::aligned16(x);
  const bool wvec = R % 4 == 0 && pyc::aligned16(w);
  const int flags = (xvec ? 1 : 0) | (wvec ? 2 : 0);
  const long long cols = tile_cols<T>();
  dim3 grid(static_cast<unsigned>((E + cols - 1) / cols),
            static_cast<unsigned>(n_splits));
  col_tile_kernel<T, CENTER, K><<<grid, kTileThreads, smem, s>>>(
      x, R, E, m, a, w, flags, n_splits, out);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for k, K = 1 .. sizeof...(Ks)
template <typename T, bool CENTER, int... Ks>
int launch_col_tile_k(int k, std::integer_sequence<int, Ks...>, const T* x,
                      long long R, long long E, const float* m,
                      const float* a, const float* w, int n_splits,
                      float* out, cudaStream_t s) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((k == Ks + 1 ? (err = launch_col_tile<T, CENTER, Ks + 1>(
                       x, R, E, m, a, w, n_splits, out, s))
                : 0),
   ...);
  return err;
}

template <typename T>
int col_tile_pass(const T* x, long long R, long long E, const float* m,
                  const float* a, const float* w, int k, int n_splits,
                  float* partial, float* y, cudaStream_t s) {
  float* out = n_splits > 1 ? partial : y;
  using Centered = std::make_integer_sequence<int, kMaxCenteredK>;
  using Uncentered = std::make_integer_sequence<int, kMaxTileK>;
  const int err =
      m != nullptr
          ? launch_col_tile_k<T, true>(k, Centered(), x, R, E, m, a, w,
                                       n_splits, out, s)
          : launch_col_tile_k<T, false>(k, Uncentered(), x, R, E, m, a, w,
                                        n_splits, out, s);
  if (err != 0 || n_splits == 1) return err;
  return reduce_chunks(partial, n_splits, static_cast<long long>(k) * E, y, s);
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

// Storage codes of the extern "C" entry points, and their element sizes.
constexpr int kFloat32 = 0;
constexpr int kInt8 = 1;
constexpr int kBfloat16 = 2;

int storage_itemsize(int storage) {
  return storage == kInt8 ? 1 : (storage == kBfloat16 ? 2 : 4);
}

// f(x as a pointer to the storage type); an unknown code is refused
template <typename F>
int with_storage(int storage, const void* x, F&& f) {
  switch (storage) {
    case kFloat32:
      return f(static_cast<const float*>(x));
    case kInt8:
      return f(static_cast<const int8_t*>(x));
    case kBfloat16:
      return f(static_cast<const __nv_bfloat16*>(x));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// storage: 0 float32 (NaN absent), 1 int8 sentinel, 2 bfloat16 (NaN
// absent).

// out[c, e] = sum_i w[c, i] * xc[i, e] for c < k; w is (k, R) and out
// (k, E). With m (centered), k in 1..8; without, k in 1..16. n_splits > 1
// goes through partial[n_splits, k, E] and a fixed-order reduce.
int pyc_col_pass(const void* x, int storage, long long R, long long E,
                 const float* m, const float* a, const float* w, int k,
                 int n_splits, float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_storage(storage, x, [&](auto xp) {
    return col_tile_pass(xp, R, E, m, a, w, k, n_splits, partial, out, s);
  });
}

// Row ranges (partials) of pyc_col_pass, and E ranges of
// pyc_row_tile_pass, for an R x E matrix on a card of n_sm SMs (the
// caller queries it once per device).
int pyc_col_tile_splits(long long R, long long E, int storage, int n_sm) {
  return col_tile_splits(R, E, storage_itemsize(storage),
                         n_sm < 1 ? 1 : n_sm);
}

int pyc_row_tile_splits(long long R, long long E, int storage, int n_sm) {
  return row_tile_splits(R, E, storage_itemsize(storage),
                         n_sm < 1 ? 1 : n_sm);
}

// t[c, i] = sum_e xc[i, e] * vt[c, e] for c < k; vt is (k, E) and t
// (k, R). With m (centered), k in 1..8; without, k in 1..16. n_splits > 1
// goes through partial[n_splits, k, R] and a fixed-order reduce.
int pyc_row_tile_pass(const void* x, int storage, long long R, long long E,
                      const float* m, const float* a, const float* vt, int k,
                      int n_splits, float* partial, float* t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_storage(storage, x, [&](auto xp) {
    return row_tile_pass(xp, R, E, m, a, vt, k, n_splits, partial, t, s);
  });
}

// t[c, i] = sum_e [x_ie absent] vt[c, e] for c < k, k = 2 only (resolve's
// row half, vt = [cert; 1]); n_splits > 1 goes through partial[n_splits,
// 2, R] and a fixed-order reduce.
int pyc_row_tile_absent(const void* x, int storage, long long R, long long E,
                        const float* vt, int k, int n_splits, float* partial,
                        float* t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k != 2 || n_splits < 1 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_storage(storage, x, [&](auto xp) {
    return row_tile_absent(xp, R, E, vt, n_splits, partial, t, s);
  });
}

// out[0, e] = sum_i rep_i [present], out[1, e] = sum_i rep_i value_ie,
// through partial[n_chunks, 2, E] and a fixed-order reduce. int8 and
// float32 storage only: the reference runs this kernel on int8 alone.
int pyc_fill_stats(const void* x, int storage, long long R, long long E,
                   const float* rep, long long n_chunks, float* partial,
                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks < 1 || n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (storage == kInt8)
    return fill_stats(static_cast<const int8_t*>(x), R, E, rep, n_chunks,
                      partial, out, s);
  if (storage == kFloat32)
    return fill_stats(static_cast<const float*>(x), R, E, rep, n_chunks,
                      partial, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
