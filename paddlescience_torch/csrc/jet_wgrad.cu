// jet_wgrad: weight and bias gradients of a jet segment, summed over the
// whole batch, deterministically; and the batch sum of d alpha.
//
// Replaces the cross-grid weight-gradient accumulation of
// paddlescience_tpu/ops/jet_pallas.py::_bwd (:526-537), where the TPU's
// sequential grid added each batch tile's dW into the same output block,
// and the same grid's sum of d alpha over batch tiles. For every layer l of
// the segment:
//   dW_l = sum_s y_in_s^T @ gz_s   (over all N rows and S streams)
//   db_l = sum_rows gz_0
// with y_in the layer's input jet (the segment input or a saved stage
// boundary) and gz the pre-activation cotangents from jet_mlp_bwd /
// jet_gated_bwd; and, given the (n_tiles, n_res) per-CTA partials of
// jet_gated_bwd, d alpha_r = sum_t partial[t][r].
//
// What bounds it on an H100: operations, L*S*2*N*K*D FLOPs in float32 FFMA
// at 67 TFLOP/s (8.6 GFLOP, 0.13 ms at S=4, N=4096, L=4, K=D=256; 37.6
// GFLOP, 0.56 ms for the aneurysm's S=7, N=2048, 3 -> 512 x 6). The reads
// of y_in and gz (134 MB at the first shape) take 0.04 ms at 3.35 TB/s.
//
// What the design does about it:
//   * dW is a sum of row outer products, and y_in (N, K) and gz (N, D) are
//     both row-major, so a stage of 32 rows lands in shared memory as
//     As[row][k] and Bs[row][c], no transpose. A CTA of 256 threads owns a
//     128 x 128 output tile; a thread an 8 x 8 micro-tile whose rows are
//     4*ty.. and 4*ty+64.. and whose columns 4*tx.. and 4*tx+64..: per
//     staged row 4 conflict-free LDS.128 feed 64 FFMA (a 4 x 4 micro-tile
//     needs 2 for 16). 2 CTAs an SM: 128 registers a thread.
//   * A ring of WG_STAGES stages is filled by 16-byte cp.async.cg copies
//     (4-byte copies where a width is not a multiple of 4), zero-filled
//     through the copy's source size at ragged rows and columns; one
//     __syncthreads per stage. (TMA would need one tensor map per stream
//     base pointer, up to S + L = 48 of them.)
//   * The parameters name layer 0's input streams one by one and every
//     later layer's input, a saved stage boundary, by the base of its (S,
//     N, K) block: a pointer per stream and layer would be 4 KB at 32
//     layers x 16 streams, the whole parameter space.
//   * One launch runs a flat list of work units (layer, output tile, row
//     range over the S*N rows of the concatenated streams). The wrapper
//     (ops/jet_mlp.py::wgrad_plan) splits each layer's rows so the units
//     fill whole waves of the card; unit u's layer, tile and rows follow
//     from per-layer prefix sums. A layer of at most WG_NARROW inputs (the
//     aneurysm's 3 -> 512) takes narrow units: an 8 x 128 tile, the 16 row
//     groups of threads splitting the staged rows and adding their 8 x 8
//     micro-tiles in a fixed order at the end, so the 3-column layer does
//     not pay for a 128-row tile.
//   * No atomics: every unit writes its own partial tile; a second kernel
//     adds the partials of each tile in unit order (float4), writes dW,
//     adds the db partials the same way and, in blocks of its own, sums
//     d alpha in the order of the former separate reduction. db comes out
//     of the staged gz rows of stream 0 in the units of the first tile row,
//     each thread row group owning its shared-memory slots. The result is
//     bitwise the same from call to call for a given shape and device.
#include "jet_common.cuh"

#define WG_T 128                        // output tile edge (K rows x D columns)
#define WG_RC 32                        // batch rows per pipeline stage
#define WG_STAGES 3                     // stages in the ring
#define WG_NARROW 8                     // layers of at most this many inputs take narrow units
#define WG_PART (WG_T * WG_T + WG_T)    // floats of one unit's partial: the tile, then db
#define WG_RBLK ((WG_PART / 4 + PSCI_THREADS - 1) / PSCI_THREADS)  // reduce blocks per tile
#define WG_STAGE_FLOATS (WG_RC * WG_T)
#define WG_SMEM ((2 * WG_STAGES * WG_STAGE_FLOATS + 16 * WG_T) * 4)

struct WgradParams {
  const float* x[PSCI_MAX_S];              // layer 0's input streams, (N, dims[0])
  const float* y[PSCI_MAX_L];              // layer l >= 1: its S input streams as one (S, N, dims[l]) block
  const float* gz[PSCI_MAX_L];             // (S, N, dims[l+1])
  float* dW[PSCI_MAX_L];                   // (dims[l], dims[l+1])
  float* db[PSCI_MAX_L];                   // (dims[l+1],)
  float* part;                             // [units][WG_PART]
  const float* apart;                      // [n_atiles][n_res] d alpha partials, or null
  float* d_alpha;                          // (n_res,)
  int dims[PSCI_MAX_L + 1];
  int splits[PSCI_MAX_L];     // row ranges of each tile of layer l
  int rows[PSCI_MAX_L];       // rows of each range (the last may be shorter)
  int unit0[PSCI_MAX_L + 1];  // first unit of layer l
  int tile0[PSCI_MAX_L + 1];  // first output tile of layer l
  int L, S, N, n_atiles, n_res;
};
static_assert(sizeof(WgradParams) <= 4096, "kernel parameters over 4 KB");
static_assert(2 * WG_STAGES * WG_STAGE_FLOATS >= 16 * WG_NARROW * WG_T, "a narrow unit's row-group sums fit the ring");

__host__ __device__ inline int wg_cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int wg_tiles_k(int K) { return K <= WG_NARROW ? 1 : wg_cdiv(K, WG_T); }

// The copies of one operand's stage: COLS per row, 16 bytes each (VEC) or
// 4; at(rr, cc, src) gives the source of row rr, column cc of the stage
// and whether it exists (else the copy writes zeros).
template <int COLS, bool VEC, class At>
__device__ __forceinline__ void copy_stage(float* dst, At at) {
#pragma unroll 1  // one copy's address live at a time: unrolled, the addresses spill at 128 registers
  for (int e = threadIdx.x; e < WG_RC * COLS; e += PSCI_THREADS) {
    const int rr = e / COLS, cc = (VEC ? 4 : 1) * (e % COLS);
    const float* src;
    const bool ok = at(rr, cc, src);
    if (VEC)
      cp_async16(dst + rr * WG_T + cc, src, ok);
    else
      cp_async4(dst + rr * WG_T + cc, src, ok);
  }
}

// Stage rows [rb, rb + WG_RC) of the concatenated streams, those before
// r1, into one ring slot: columns [k0, k0 + AW) of the layer inputs ys[s]
// (N, K) into As[WG_RC][WG_T], columns [c0, c0 + WG_T) of gz (S*N, D) into
// Bs. Columns at or past K (D) and rows at or past r1 are zero. 16-byte
// copies where K (D) is a multiple of 4, else 4-byte ones.
template <int AW>
__device__ __forceinline__ void stage_load(float* As, float* Bs, const float* const* ys, const float* gz, int S,
                                           int N, int K, int D, int k0, int c0, int rb, int r1) {
  const int s0 = rb / N, n0 = rb - s0 * N;  // stream and row of the stage's first row
  const float* ya = ys[s0] + (size_t)n0 * K + k0;
  auto at_a = [&](int rr, int cc, const float*& src) {  // the stage lies in one stream
    const bool ok = rb + rr < r1 && k0 + cc < K;
    src = ok ? ya + (size_t)rr * K + cc : gz;
    return ok;
  };
  auto at_a_across = [&](int rr, int cc, const float*& src) {  // the stage runs into the next streams
    int s = s0, n = n0 + rr;
    while (n >= N) {
      n -= N;
      ++s;
    }
    const bool ok = rb + rr < r1 && k0 + cc < K;
    src = ok ? ys[min(s, S - 1)] + (size_t)n * K + k0 + cc : gz;
    return ok;
  };
  const float* gb = gz + (size_t)rb * D + c0;
  auto at_b = [&](int rr, int cc, const float*& src) {
    const bool ok = rb + rr < r1 && c0 + cc < D;
    src = ok ? gb + (size_t)rr * D + cc : gz;
    return ok;
  };
  if (n0 + WG_RC <= N) {
    if (K % 4 == 0)
      copy_stage<AW / 4, true>(As, at_a);
    else
      copy_stage<AW, false>(As, at_a);
  } else {
    if (K % 4 == 0)
      copy_stage<AW / 4, true>(As, at_a_across);
    else
      copy_stage<AW, false>(As, at_a_across);
  }
  if (D % 4 == 0)
    copy_stage<WG_T / 4, true>(Bs, at_b);
  else
    copy_stage<WG_T, false>(Bs, at_b);
}

// One work unit: the partial dW tile (rows k0.., columns c0..) of layer l
// over rows [r0, r1) of the concatenated streams, and with `bias` the
// partial db of columns c0.. over the rows of stream 0 among them, into
// out[WG_PART]. NARROW: the tile is WG_NARROW x WG_T and the row groups of
// threads split the staged rows.
template <bool NARROW>
__device__ __forceinline__ void wgrad_unit(const WgradParams& p, float* smem, const float* const* bases, int l,
                                           int k0, int c0, int r0, int r1, bool bias, float* __restrict__ out) {
  const int K = p.dims[l], D = p.dims[l + 1], N = p.N;
  // a warp covers 8 tx x 4 ty, so a fragment load touches at most 8 float4 (128 bytes)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (lane & 7) + 8 * (warp & 1), ty = (lane >> 3) + 4 * (warp >> 1);
  float* As = smem;
  float* Bs = smem + WG_STAGES * WG_STAGE_FLOATS;
  float* dbs = Bs + WG_STAGES * WG_STAGE_FLOATS;  // [16][WG_T]: row group ty's db sums
  const int n_st = wg_cdiv(r1 - r0, WG_RC);
  const int ka = NARROW ? 0 : 4 * ty;  // this thread's first tile row in a staged row of A
  if (bias) {
    *reinterpret_cast<float4*>(dbs + ty * WG_T + 4 * tx) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dbs + ty * WG_T + 64 + 4 * tx) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  auto load = [&](int st) {
    const int buf = st % WG_STAGES;
    stage_load<NARROW ? WG_NARROW : WG_T>(As + buf * WG_STAGE_FLOATS, Bs + buf * WG_STAGE_FLOATS, bases,
                                          bases[PSCI_MAX_S], p.S, N, K, D, k0, c0, r0 + st * WG_RC, r1);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < WG_STAGES - 1; ++st) {
    if (st < n_st) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // stage st has landed for every thread; stage st - 1's buffer is free
    if (st + WG_STAGES - 1 < n_st) load(st + WG_STAGES - 1);
    cp_async_commit();
    const float* a = As + (st % WG_STAGES) * WG_STAGE_FLOATS;
    const float* b = Bs + (st % WG_STAGES) * WG_STAGE_FLOATS;
    // NARROW: row group ty takes staged rows ty, ty + 16; otherwise every thread every row
#pragma unroll
    for (int h = 0; h < (NARROW ? WG_RC / 16 : WG_RC); ++h) {
      const int rr = NARROW ? ty + 16 * h : h;
      const float4 a0 = *reinterpret_cast<const float4*>(a + rr * WG_T + ka);
      const float4 a1 = *reinterpret_cast<const float4*>(a + rr * WG_T + ka + (NARROW ? 4 : 64));
      const float4 b0 = *reinterpret_cast<const float4*>(b + rr * WG_T + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b + rr * WG_T + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (bias) {  // db: row group ty adds staged rows ty, ty + 16 that belong to stream 0
      const int rb = r0 + st * WG_RC;
#pragma unroll
      for (int h = 0; h < WG_RC / 16; ++h) {
        const int rr = ty + 16 * h;
        if (rb + rr < N) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float4* d = reinterpret_cast<float4*>(dbs + ty * WG_T + 64 * half + 4 * tx);
            const float4 g = *reinterpret_cast<const float4*>(b + rr * WG_T + 64 * half + 4 * tx);
            *d = make_float4(d->x + g.x, d->y + g.y, d->z + g.z, d->w + g.w);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring is free for the epilogue

  if (NARROW) {
    // add the 16 row groups' micro-tiles in order: red[q][i][c], q = row group
    float* red = smem;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(red + (ty * 8 + i) * WG_T + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(red + (ty * 8 + i) * WG_T + 64 + 4 * tx) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    const int i = threadIdx.x / (WG_T / 4), c = 4 * (threadIdx.x % (WG_T / 4));
    float4 s = *reinterpret_cast<const float4*>(red + i * WG_T + c);
    for (int q = 1; q < 16; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(red + (q * 8 + i) * WG_T + c);
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    *reinterpret_cast<float4*>(out + i * WG_T + c) = s;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
      *reinterpret_cast<float4*>(out + k * WG_T + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + k * WG_T + 64 + 4 * tx) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  if (bias && threadIdx.x < WG_T / 4) {  // the row groups' db sums, in order
    const int c = 4 * threadIdx.x;
    float4 s = *reinterpret_cast<const float4*>(dbs + c);
    for (int q = 1; q < 16; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(dbs + q * WG_T + c);
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    *reinterpret_cast<float4*>(out + WG_T * WG_T + c) = s;
  }
}

// Units of layer l: for split q of its rows and tile t, unit unit0[l] +
// q * tiles_l + t (the tiles of one row range run side by side and share
// their rows through L2).
__global__ void __launch_bounds__(PSCI_THREADS, 2) jet_wgrad_partial(const WgradParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* bases[PSCI_MAX_S + 1];  // the layer's S input streams, then its gz
  const int u = blockIdx.x;
  int l = 0;
  while (u >= p.unit0[l + 1]) ++l;
  const int K = p.dims[l], D = p.dims[l + 1];
  const int tiles_d = wg_cdiv(D, WG_T), tiles = wg_tiles_k(K) * tiles_d;
  const int q = (u - p.unit0[l]) / tiles, t = (u - p.unit0[l]) % tiles;
  const int k0 = (t / tiles_d) * WG_T, c0 = (t % tiles_d) * WG_T;
  const int r0 = q * p.rows[l], r1 = min(p.S * p.N, r0 + p.rows[l]);
  if (threadIdx.x < p.S) bases[threadIdx.x] = l == 0 ? p.x[threadIdx.x] : p.y[l] + (size_t)threadIdx.x * p.N * K;
  if (threadIdx.x == 0) bases[PSCI_MAX_S] = p.gz[l];
  __syncthreads();
  float* out = p.part + (size_t)u * WG_PART;
  const bool bias = k0 == 0 && r0 < p.N;
  if (K <= WG_NARROW)
    wgrad_unit<true>(p, smem, bases, l, k0, c0, r0, r1, bias, out);
  else
    wgrad_unit<false>(p, smem, bases, l, k0, c0, r0, r1, bias, out);
}

// Second pass. Blocks [0, tiles * WG_RBLK): each thread one float4 of a
// tile's partial (dW element or db), the tile's splits added in order.
// Blocks after them: d alpha of one residual each, thread i adding the
// partials t = i, i + 256, ... in order, then a shared-memory tree.
__global__ void __launch_bounds__(PSCI_THREADS) jet_wgrad_reduce(const WgradParams p) {
  const int n_tiles = p.tile0[p.L];
  if ((int)blockIdx.x >= n_tiles * WG_RBLK) {
    __shared__ float sums[PSCI_THREADS];
    const int r = blockIdx.x - n_tiles * WG_RBLK;
    float sum = 0.f;
    for (int t = threadIdx.x; t < p.n_atiles; t += PSCI_THREADS) sum += p.apart[(size_t)t * p.n_res + r];
    sums[threadIdx.x] = sum;
    __syncthreads();
    for (int o = PSCI_THREADS / 2; o > 0; o >>= 1) {
      if ((int)threadIdx.x < o) sums[threadIdx.x] += sums[threadIdx.x + o];
      __syncthreads();
    }
    if (threadIdx.x == 0) p.d_alpha[r] = sums[0];
    return;
  }
  const int tile = blockIdx.x / WG_RBLK;
  const int e = (blockIdx.x % WG_RBLK) * PSCI_THREADS + threadIdx.x;  // float4 of the partial
  int l = 0;
  while (tile >= p.tile0[l + 1]) ++l;
  const int K = p.dims[l], D = p.dims[l + 1];
  const int tiles_d = wg_cdiv(D, WG_T), t = tile - p.tile0[l];
  const int tiles = p.tile0[l + 1] - p.tile0[l];
  const int k0 = (t / tiles_d) * WG_T, c0 = (t % tiles_d) * WG_T;
  int n_q = p.splits[l];
  float* dst;
  int c;
  if (e < WG_T * WG_T / 4) {
    const int k = k0 + e / (WG_T / 4);
    c = c0 + 4 * (e % (WG_T / 4));
    if (k >= K || c >= D) return;
    dst = p.dW[l] + (size_t)k * D + c;
  } else if (e < WG_PART / 4 && k0 == 0) {
    c = c0 + 4 * (e - WG_T * WG_T / 4);
    if (c >= D) return;
    dst = p.db[l] + c;
    n_q = min(n_q, wg_cdiv(p.N, p.rows[l]));  // the splits that hold rows of stream 0
  } else {
    return;
  }
  const float* src = p.part + (size_t)(p.unit0[l] + t) * WG_PART + 4 * e;
  const size_t step = (size_t)tiles * WG_PART;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int q = 1; q < n_q; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(src + q * step);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {  // a layer before may have left it unaligned
    *reinterpret_cast<float4*>(dst) = s;
  } else {
    const float sv[4] = {s.x, s.y, s.z, s.w};
    for (int j = 0; j < 4 && c + j < D; ++j) dst[j] = sv[j];
  }
}

// Host entry point. x is a host array of the S device pointers of layer
// 0's input streams, y one of L device pointers whose entries 1..L-1 are
// the layers' (S, N, dims[l]) input blocks (y[0] is not read; 16-byte
// aligned where the width is a multiple of 4), gz, dW, db host arrays of L
// device pointers;
// dims[L+1]; plan[2L] the row splits and rows per split of each layer (from
// ops/jet_mlp.py::wgrad_plan); part device scratch of units * WG_PART
// floats. With n_res > 0, apart is the (n_atiles, n_res) d alpha partials
// and d_alpha receives their sums. Returns a cudaError_t code (0 = launched).
extern "C" int jet_wgrad(const void* const* x, const void* const* y, const void* const* gz, void* const* dW,
                         void* const* db, void* part, const int* dims, const int* plan, const void* apart,
                         void* d_alpha, int n_atiles, int n_res, int S, int L, int N, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || n_res < 0 ||
      (n_res > 0 && (apart == nullptr || d_alpha == nullptr || n_atiles < 1)))
    return (int)cudaErrorInvalidValue;
  WgradParams p = {};
  for (int l = 0; l < L; ++l) {
    const int K = dims[l], D = dims[l + 1], splits = plan[2 * l], rows = plan[2 * l + 1];
    if (K < 1 || D < 1 || splits < 1 || rows < 1 || (long long)splits * rows < (long long)S * N ||
        (long long)(splits - 1) * rows >= (long long)S * N)
      return (int)cudaErrorInvalidValue;
    if (l > 0 && y[l] == nullptr) return (int)cudaErrorInvalidValue;
    p.y[l] = l > 0 ? static_cast<const float*>(y[l]) : nullptr;
    p.gz[l] = static_cast<const float*>(gz[l]);
    p.dW[l] = static_cast<float*>(dW[l]);
    p.db[l] = static_cast<float*>(db[l]);
    p.splits[l] = splits;
    p.rows[l] = rows;
    const int tiles = wg_tiles_k(K) * wg_cdiv(D, WG_T);
    p.tile0[l + 1] = p.tile0[l] + tiles;
    p.unit0[l + 1] = p.unit0[l] + tiles * splits;
  }
  for (int s = 0; s < S; ++s) p.x[s] = static_cast<const float*>(x[s]);
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.part = static_cast<float*>(part);
  p.apart = static_cast<const float*>(apart);
  p.d_alpha = static_cast<float*>(d_alpha);
  p.L = L;
  p.S = S;
  p.N = N;
  p.n_atiles = n_atiles;
  p.n_res = n_res;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(jet_wgrad_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  jet_wgrad_partial<<<p.unit0[L], PSCI_THREADS, WG_SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  jet_wgrad_reduce<<<p.tile0[L] * WG_RBLK + n_res, PSCI_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Work units the current device runs at once: SMs x resident CTAs of
// jet_wgrad_partial (registers and shared memory permitting). Returns a
// cudaError_t code.
extern "C" int jet_wgrad_slots(int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jet_wgrad_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jet_wgrad_partial, PSCI_THREADS, WG_SMEM);
  *slots = sms * per_sm;
  return (int)err;
}

PSCI_ERROR_STRING_FN
