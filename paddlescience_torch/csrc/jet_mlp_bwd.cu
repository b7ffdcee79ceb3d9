// jet_mlp_bwd: staged backward of the fused MLP jet segment, per row tile.
//
// Replaces the per-tile part of paddlescience_tpu/ops/jet_pallas.py::_bwd
// (pallas_call at :557, with _staged_vjp :410-485) for the ungated MLP
// body: walk the layers in reverse from the saved (or freshly recomputed)
// stage boundary y_in, and for each layer
//   1. recompute z_s = y_in_s @ W (+ b on the primal),
//   2. form the pre-activation cotangents by the hand-derived VJP of the
//      activation's jet rule (jet_common.cuh, jet_rule_vjp, with f', f'',
//      f''' of the activation at z_0 from psci_act):
//        gz_0  = f' g_0 + f'' sum_k g_k z_k
//                + sum_ij (f''' z_i z_j + f'' z_ij) g_ij
//        gz_k  = f' g_k + sum_{pairs ij containing k} f'' g_ij z_other
//        gz_ij = f' g_ij,
//   3. write gz for the weight gradient (jet_wgrad.cu),
//   4. propagate g_yin_s = gz_s @ W^T; after layer 0 these are the
//      cotangents of the segment's input streams.
// The weight gradient's sum over the batch is jet_wgrad's job: on the TPU
// the sequential grid carried it, here the CTAs run in no order.
//
// What bounds it on an H100: operations, 2*L*S*2*N*K*D FLOPs in float32:
// 17.2 GFLOP at S=4, N=4096, L=4, K=D=256 (0.26 ms at 67 TFLOP/s) against
// ~170 MB of boundary, cotangent and gz traffic (0.05 ms at 3.35 TB/s);
// 75.2 GFLOP for the aneurysm MLP's five 512-wide layers at S=7, N=2048
// (1.12 ms). Two things keep the design from that bound:
//   * its products issue S + 1 shared loads (one float4 of each stream's
//     layer input or cotangent, one of the weights) per 8S FMAs, as
//     jet_gated_bwd.cu's, which run at under half of the FMA rate;
//   * every CTA streams every weight from L2 twice a layer: at the
//     aneurysm shape (8-row tiles) 256 CTAs x 2 x 5 MB = 2.6 GB a call. A
//     cluster of 2 CTAs that multicasts each weight chunk would halve it.
//
// Design, for the H100 (the products are jet_gated_bwd.cu's, from
// jet_common.cuh):
//   * 512 threads a CTA within 128 registers (16 warps an SM), each owning
//     a 4-row x 2-column micro-tile of every stream: 128 x 4 threads cover
//     a 16-row tile up to width 256, 256 x 2 threads an 8-row tile up to
//     width 512 (jet_mlp_fwd.cu's tile rows). The layer input A, and where
//     it fits the running cotangent G, of all S streams live in shared
//     memory, transposed ([S][kmax][BM]).
//   * The layer input (and the segment's output cotangent) reach their
//     tile through 4-byte cp.async copies (stage_tile), all in flight at
//     once, taken in by the z product's first wait.
//   * Both products (ring_matmul: z = y_in @ W; ring_matmul_t: gz @ W^T)
//     stage 16-row or 16-column chunks of W with 16-byte cp.async copies
//     into a ring of GB_STAGES chunks, one __syncthreads a chunk: the copy
//     of chunk c+1 is in flight while chunk c is computed. The W^T chunk
//     lands in W's own row-major layout, its 16-byte pieces swizzled by
//     row, so its reads hit 32 distinct banks and nothing is transposed
//     element by element; that product's outputs are columns tx + TX j.
//   * The elementwise VJP holds one micro-tile: z from the z product,
//     overwritten by gz. Where G is in shared memory it reads each column
//     of its cotangents as one float4 (columns outer, rows inner); where
//     the cotangent is parked in device memory it reads it row by row as
//     float2 (rows outer, columns inner). gz goes to the gz buffer as
//     float2 rows and into G as float4 columns, where ring_matmul_t reads
//     it.
//   * One tile where two and the ring do not fit (PARK; S >= 7 at width
//     256, S >= 6 at 512, e.g. 7 x 512 x 8 rows = 112 KB a tile, 180 KB
//     with the ring): G shares A's shared memory; ring_matmul_t's result,
//     the next layer's output cotangent, is parked in that layer's gz
//     buffer in device memory (L2), read back by the thread that owns it
//     in the elementwise part, and overwritten there by gz.
//   * No atomics and a fixed summation order: two calls on the same inputs
//     are bitwise equal.
// The activation is a runtime id; the two-tile kernels at 16 rows also
// come specialised to tanh (ANY = false), as in jet_mlp_fwd.cu.
//
// More than PSCI_GROUP_S streams (jet_mlp_bwd_halves): a micro-tile of
// every stream would be 8 * S registers, all 128 of a 512-thread CTA's at
// S = 16. So both products run over the two halves of the streams in turn
// with at most 8 streams of accumulators, on one tile that always parks
// the cotangent: z of each half goes back over that half's rows of the
// layer input (a stream's product reads only that stream); the VJP reads
// z of all S streams of an element from the tile and their output
// cotangents from the parked rows, and writes gz over both; each half's
// W^T product writes its streams' input cotangents to device memory (the
// segment's, or parked in the previous layer's gz buffer). The weights
// stream from L2 once per half and product.
#include "jet_common.cuh"

struct BwdParams {
  const float* x[PSCI_MAX_S];        // segment input streams, (N, dims[0])
  const float* bounds[PSCI_MAX_L];   // bounds[l]: (S, N, dims[l+1]) entering layer l+1
  const float* W[PSCI_MAX_L];
  const float* b[PSCI_MAX_L];
  const float* gout[PSCI_MAX_S];     // cotangents of the segment outputs, (N, dims[L])
  float* gin[PSCI_MAX_S];            // cotangents of the segment inputs, (N, dims[0])
  float* gz[PSCI_MAX_L];             // gz[l]: (S, N, dims[l+1]); with PARK it holds the layer's output
                                     // cotangent until gz overwrites it
  int dims[PSCI_MAX_L + 1];
  JetIdx idx;
  Act act;
  int L, N, kmax;
};

// The VJP of the activation's jet rule on element (i, j) of the micro-tile:
// acc holds z there on entry and gz on exit; g the output cotangents.
template <int S>
__device__ __forceinline__ void vjp_elem(Tile<S>& acc, const float (&g)[S], const Act act, const JetIdx& idx,
                                         int i, int j) {
  float z[S], f, f1, f2, f3;
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = acc[s][i][j];
  psci_act(act, z[0], f, f1, f2, f3);
  jet_rule_vjp<S>(z, g, f1, f2, f3, idx);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
}

template <int S, int BM, bool PARK, bool ANY>
__global__ void __launch_bounds__(GB_THREADS, 1) jet_mlp_bwd_kernel(const BwdParams p) {
  constexpr int TX = GB_TX<BM>;
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  const size_t tile = (size_t)S * p.kmax * BM;
  float* A = smem;                               // layer input y_in, [S][kmax][BM]
  float* G = PARK ? smem : smem + tile;          // running cotangent, [S][kmax][BM] (PARK: shares A's tile)
  float* ring = smem + (PARK ? 1 : 2) * tile;    // GB_STAGES weight chunks
  const int stage = PSCI_KC * p.kmax;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  if (!PARK) {
    const float* src[S];
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = p.gout[s];
    stage_tile<S, BM>(G, p.kmax, src, p.dims[p.L], row0, p.N);
  }

  for (int l = p.L - 1; l >= 0; --l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    {
      const float* src[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        src[s] = (l == 0) ? p.x[s] : p.bounds[l - 1] + (size_t)s * p.N * K;
      stage_tile<S, BM>(A, p.kmax, src, K, row0, p.N);
    }
    Tile<S> acc;
    gb_zero<S>(acc);
    ring_matmul<S, BM>(acc, A, p.kmax, p.W[l], K, D, ring, stage, tx, ty);  // z; ends with a barrier
    float* const gzl = p.gz[l];  // (S, N, D): PARK: the parked output cotangent, then gz
    const size_t zs = (size_t)p.N * D;
    if (GB_CN * tx < D) {
      gb_add_bias<S>(acc, p.b[l], tx);
      if (PARK) {
        // rows outer: the output cotangent row by row (the segment's, or
        // where the previous layer's W^T product parked it), gz back over it
#pragma unroll
        for (int i = 0; i < GB_RM; ++i) {
          const int n = row0 + GB_RM * ty + i;
          const size_t off = (size_t)n * D + GB_CN * tx;
          float gr[S][GB_CN];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            fill<GB_CN>(gr[s], 0.f);
            if (n < p.N) ld<GB_CN>((l == p.L - 1 ? p.gout[s] : gzl + s * zs) + off, gr[s]);  // plain loads
          }
#pragma unroll
          for (int j = 0; j < GB_CN; ++j) {
            float g[S];
#pragma unroll
            for (int s = 0; s < S; ++s) g[s] = gr[s][j];
            vjp_elem<S>(acc, g, act, p.idx, i, j);
          }
          if (n < p.N) {
#pragma unroll
            for (int s = 0; s < S; ++s) st<GB_CN>(gzl + s * zs + off, acc[s][i]);
          }
        }
      } else {
        // columns outer: each column of the cotangents as one float4 from G
        // (only this thread reads and then writes these elements of G)
#pragma unroll
        for (int j = 0; j < GB_CN; ++j) {
          float gc[S][GB_RM];
#pragma unroll
          for (int s = 0; s < S; ++s) ld<GB_RM>(G + ((size_t)s * p.kmax + GB_CN * tx + j) * BM + GB_RM * ty, gc[s]);
#pragma unroll
          for (int i = 0; i < GB_RM; ++i) {
            float g[S];
#pragma unroll
            for (int s = 0; s < S; ++s) g[s] = gc[s][i];
            vjp_elem<S>(acc, g, act, p.idx, i, j);
          }
        }
        float* dst[S];
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = gzl + s * zs;
        gb_store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
      }
      gb_store_tile<S, BM>(G, p.kmax, acc, tx, ty);  // the operand of gz @ W^T
    }

    gb_zero<S>(acc);
    ring_matmul_t<S, BM, true>(acc, G, p.kmax, p.W[l], K, D, ring, stage, tx, ty);  // gz @ W^T; ends with a barrier
    // output column k = tx + TX j of every stream: the segment's input
    // cotangent (layer 0), parked in gz[l-1] (PARK), or back into G
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) {
      const int k = tx + TX * j;
      if (k >= K) continue;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (l == 0 || PARK) {
          float* dst = l == 0 ? p.gin[s] : p.gz[l - 1] + (size_t)s * p.N * K;
#pragma unroll
          for (int i = 0; i < GB_RM; ++i) {
            const int n = row0 + GB_RM * ty + i;
            if (n < p.N) dst[(size_t)n * K + k] = acc[s][i][j];
          }
        } else {
          gb_store_col<S, BM>(G, p.kmax, acc, s, j, k, ty);
        }
      }
    }
    // no barrier: the next layer's ring_matmul publishes A, G and the parked
    // rows before any thread reads them
  }
}

// z of one half of the streams (G of them, the tile's streams from Ah on)
// through layer l's product, back over their layer input in the tile.
template <int G, int BM>
__device__ __forceinline__ void bwd_z_half(float* Ah, const BwdParams& p, int l, float* ring, int tx, int ty) {
  const int D = p.dims[l + 1];
  Tile<G> acc;
  gb_zero<G>(acc);
  ring_matmul<G, BM>(acc, Ah, p.kmax, p.W[l], p.dims[l], D, ring, PSCI_KC * p.kmax, tx, ty);  // ends with a barrier
  if (GB_CN * tx < D) gb_store_tile<G, BM>(Ah, p.kmax, acc, tx, ty);
}

// gz @ W^T of one half (streams s0 .. s0 + G - 1, gz in the tile from Gh
// on): the segment's input cotangents at layer 0, else parked in gz[l-1].
template <int G, int BM>
__device__ __forceinline__ void bwd_gin_half(const float* Gh, int s0, const BwdParams& p, int l, float* ring, int tx,
                                             int ty) {
  constexpr int TX = GB_TX<BM>;
  const int K = p.dims[l], row0 = blockIdx.x * BM;
  Tile<G> acc;
  gb_zero<G>(acc);
  ring_matmul_t<G, BM, true>(acc, Gh, p.kmax, p.W[l], K, p.dims[l + 1], ring, PSCI_KC * p.kmax, tx, ty);
#pragma unroll
  for (int j = 0; j < GB_CN; ++j) {
    const int k = tx + TX * j;
    if (k >= K) continue;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      float* dst = l == 0 ? p.gin[s0 + s] : p.gz[l - 1] + (size_t)(s0 + s) * p.N * K;
#pragma unroll
      for (int i = 0; i < GB_RM; ++i) {
        const int n = row0 + GB_RM * ty + i;
        if (n < p.N) dst[(size_t)n * K + k] = acc[s][i][j];
      }
    }
  }
}

template <int S, int BM>
__global__ void __launch_bounds__(GB_THREADS, 1) jet_mlp_bwd_halves(const BwdParams p) {
  constexpr int TX = GB_TX<BM>, G0 = (S + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                                   // [S][kmax][BM]: the layer input, then z, then gz
  float* ring = smem + (size_t)S * p.kmax * BM;      // GB_STAGES weight chunks
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  for (int l = p.L - 1; l >= 0; --l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    {
      const float* src[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        src[s] = (l == 0) ? p.x[s] : p.bounds[l - 1] + (size_t)s * p.N * K;
      stage_tile<S, BM>(A, p.kmax, src, K, row0, p.N);
    }
    bwd_z_half<G0, BM>(A, p, l, ring, tx, ty);
    bwd_z_half<S - G0, BM>(A + (size_t)G0 * p.kmax * BM, p, l, ring, tx, ty);
    __syncthreads();  // z of every stream is in the tile
    if (GB_CN * tx < D) {
      // rows outer: the output cotangents of row n (the segment's, or where
      // the next layer's W^T product parked them) for the thread's two
      // columns, the VJP element by element, gz back over z and the
      // cotangents
      float* const gzl = p.gz[l];
      const size_t zs = (size_t)p.N * D;
      float bias[GB_CN];
      ldg<GB_CN>(p.b[l] + GB_CN * tx, bias);
#pragma unroll 1
      for (int i = 0; i < GB_RM; ++i) {
        const int r = GB_RM * ty + i, n = row0 + r;
        const size_t off = (size_t)n * D + GB_CN * tx;
        float gr[S][GB_CN];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          fill<GB_CN>(gr[s], 0.f);
          if (n < p.N) ld<GB_CN>((l == p.L - 1 ? p.gout[s] : gzl + s * zs) + off, gr[s]);  // plain loads
        }
#pragma unroll
        for (int j = 0; j < GB_CN; ++j) {
          float* a = A + (size_t)(GB_CN * tx + j) * BM + r;  // element (c, r) of stream 0
          float z[S], g[S], f, f1, f2, f3;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            z[s] = a[(size_t)s * p.kmax * BM];
            g[s] = gr[s][j];
          }
          z[0] += bias[j];
          psci_act(p.act, z[0], f, f1, f2, f3);
          jet_rule_vjp<S>(z, g, f1, f2, f3, p.idx);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            a[(size_t)s * p.kmax * BM] = z[s];
            gr[s][j] = z[s];
          }
        }
        if (n < p.N) {
#pragma unroll
          for (int s = 0; s < S; ++s) st<GB_CN>(gzl + s * zs + off, gr[s]);
        }
      }
    }
    // the W^T products' first barrier publishes gz in the tile
    bwd_gin_half<G0, BM>(A, 0, p, l, ring, tx, ty);
    bwd_gin_half<S - G0, BM>(A + (size_t)G0 * p.kmax * BM, G0, p, l, ring, tx, ty);
    // no barrier: the next layer's stage_tile overwrites the tile only after
    // the last product's closing barrier
  }
}

template <int S, int BM>
static cudaError_t launch_halves(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem(S, p.kmax, BM, 1);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_bwd_halves<S, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_bwd_halves<S, BM><<<grid, GB_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int S, int BM, bool PARK, bool ANY>
static cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem(S, p.kmax, BM, PARK);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_bwd_kernel<S, BM, PARK, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_bwd_kernel<S, BM, PARK, ANY><<<grid, GB_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, bool ANY>
static cudaError_t launch_s(const BwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 1: return launch<1, BM, false, ANY>(p, st);
    case 2: return launch<2, BM, false, ANY>(p, st);
    case 3: return launch<3, BM, false, ANY>(p, st);
    case 4: return launch<4, BM, false, ANY>(p, st);
    case 5: return launch<5, BM, false, ANY>(p, st);
    case 6: return launch<6, BM, false, ANY>(p, st);
    case 7: return launch<7, BM, false, ANY>(p, st);
    default: return launch<8, BM, false, ANY>(p, st);
  }
}

// Only S >= 6 parks (ops/jet_mlp.py::bwd_parks): 7 and 8 at 16 rows, 6-8 at 8.
template <int BM>
static cudaError_t launch_parked(const BwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 6: return launch<6, BM, true, true>(p, st);
    case 7: return launch<7, BM, true, true>(p, st);
    case 8: return launch<8, BM, true, true>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// More than PSCI_GROUP_S streams: the halves kernel, which always parks.
template <int BM>
static cudaError_t launch_halves_s(const BwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 9: return launch_halves<9, BM>(p, st);
    case 10: return launch_halves<10, BM>(p, st);
    case 11: return launch_halves<11, BM>(p, st);
    case 12: return launch_halves<12, BM>(p, st);
    case 13: return launch_halves<13, BM>(p, st);
    case 14: return launch_halves<14, BM>(p, st);
    case 15: return launch_halves<15, BM>(p, st);
    case 16: return launch_halves<16, BM>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// Host entry point. Pointer arguments are host arrays of device pointers:
// x[S], bounds[L-1], W[L], b[L], gout[S], gin[S], gz[L]; dims[L+1];
// kind/pa/pb[S]. kmax >= every dims[l], rounded up to a multiple of 4.
// bm: rows per tile, 16 (widths <= 256) or 8 (widths <= 512; above
// PSCI_GROUP_S streams whichever holds the tile: ops/jet_mlp.py::tile_rows);
// park: keep the running cotangent in gz (1, S >= 6, and always above
// PSCI_GROUP_S streams) or in shared memory (0); act,
// act_w: the activation's id and parameter. Returns a cudaError_t code
// (0 = launched).
extern "C" int jet_mlp_bwd(const void* const* x, const void* const* bounds, const void* const* W,
                           const void* const* b, const void* const* gout, void* const* gin,
                           void* const* gz, const int* dims, const int* kind, const int* pa,
                           const int* pb, int S, int L, int N, int kmax, int bm, int park, int act,
                           float act_w, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || act < 0 || act >= PSCI_N_ACTS ||
      kmax % 4 || (park != 0 && park != 1))
    return (int)cudaErrorInvalidValue;
  if (!(bm == PSCI_BM && kmax <= 4 * 64) && !(bm == PSCI_BM_WIDE && kmax <= 4 * 128))
    return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  for (int s = 0; s < S; ++s) {
    p.x[s] = static_cast<const float*>(x[s]);
    p.gout[s] = static_cast<const float*>(gout[s]);
    p.gin[s] = static_cast<float*>(gin[s]);
    p.idx.kind[s] = kind[s];
    p.idx.pa[s] = pa[s];
    p.idx.pb[s] = pb[s];
  }
  for (int l = 0; l < L; ++l) {
    if (dims[l + 1] % 4 || dims[l + 1] > kmax || dims[l] > kmax) return (int)cudaErrorInvalidValue;
    p.W[l] = static_cast<const float*>(W[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.gz[l] = static_cast<float*>(gz[l]);
    p.bounds[l] = l < L - 1 ? static_cast<const float*>(bounds[l]) : nullptr;
  }
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.act = Act{act, act_w};
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > PSCI_GROUP_S) {
    if (!park) return (int)cudaErrorInvalidValue;
    return (int)(bm == PSCI_BM_WIDE ? launch_halves_s<PSCI_BM_WIDE>(p, S, st) : launch_halves_s<PSCI_BM>(p, S, st));
  }
  if (bm == PSCI_BM_WIDE)
    return (int)(park ? launch_parked<PSCI_BM_WIDE>(p, S, st) : launch_s<PSCI_BM_WIDE, true>(p, S, st));
  if (park) return (int)launch_parked<PSCI_BM>(p, S, st);
  return (int)(act == PSCI_TANH ? launch_s<PSCI_BM, false>(p, S, st) : launch_s<PSCI_BM, true>(p, S, st));
}

PSCI_ERROR_STRING_FN
