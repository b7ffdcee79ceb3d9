// jet_mlp_bwd: staged backward of the fused MLP jet segment, per row tile.
//
// Replaces the per-tile part of paddlescience_tpu/ops/jet_pallas.py::_bwd
// (pallas_call at :557, with _staged_vjp :410-485): walk the layers in
// reverse from the saved (or freshly recomputed) stage boundary y_in, and
// for each layer
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
// (1.12 ms).
//
// Design: one CTA per row tile (16 rows up to width 256, 8 above, as
// jet_mlp_fwd.cu) keeps the layer input A of all S streams in shared
// memory; weights stream from L2 in 16-row (forward product) or 16-column
// (transposed product) chunks; micro-tiles as in jet_mlp_fwd.cu. The
// running cotangent G is only read elementwise, by the thread that owns the
// element, before it becomes the operand of gz @ W^T. Where a second tile
// fits (S <= 6 at width 256) G lives in shared memory; otherwise (PARK: 7-8
// streams at 256, every stream count at 512, e.g. 7 x 512 x 8 rows = 112 KB
// per tile) each thread parks its micro-tile of G in the layer's gz buffer
// in device memory (L2) and reads it back there before overwriting it with
// gz, so one tile and one weight chunk fit: 147 KB at S = 7, width 512.
// The activation is a runtime id; the two-tile kernels also come
// specialised to tanh (ANY = false), as in jet_mlp_fwd.cu.
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

template <int S, int BM, bool PARK, bool ANY>
__global__ void __launch_bounds__(PSCI_THREADS, 1) jet_mlp_bwd_kernel(const BwdParams p) {
  constexpr int TX = 4 * PSCI_THREADS / BM;
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  const size_t tile = (size_t)S * p.kmax * BM;
  float* A = smem;                             // layer input y_in, [S][kmax][BM]
  float* G = PARK ? smem : smem + tile;        // running cotangent, [S][kmax][BM] (PARK: shares A's tile)
  float* Wc = smem + (PARK ? 1 : 2) * tile;    // weight chunk
  const int kpad = p.kmax + 4;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  if (!PARK) {
    const float* src[S];
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = p.gout[s];
    load_tile<S, BM>(G, p.kmax, src, p.dims[p.L], row0, p.N);
  }

  for (int l = p.L - 1; l >= 0; --l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    {
      const float* src[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        src[s] = (l == 0) ? p.x[s] : p.bounds[l - 1] + (size_t)s * p.N * K;
      load_tile<S, BM>(A, p.kmax, src, K, row0, p.N);
    }
    __syncthreads();

    float acc[S][4][4];
    zero_acc<S>(acc);
    tile_matmul<S, BM>(acc, A, p.kmax, p.W[l], K, D, Wc, tx, ty);  // z; ends with a barrier
    if (4 * tx < D) {
      add_bias<S>(acc, p.b[l], tx);
      if (PARK) {
        // the output cotangent: the segment's, or where this thread parked it
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = row0 + 4 * ty + i;
          float4 gv[S];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float* q = l == p.L - 1 ? p.gout[s] : p.gz[l] + (size_t)s * p.N * D;
            gv[s] = n < p.N ? *(reinterpret_cast<const float4*>(q + (size_t)n * D) + tx)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float z[S], g[S], f, f1, f2, f3;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              z[s] = acc[s][i][j];
              g[s] = j == 0 ? gv[s].x : j == 1 ? gv[s].y : j == 2 ? gv[s].z : gv[s].w;
            }
            psci_act(act, z[0], f, f1, f2, f3);
            jet_rule_vjp<S>(z, g, f1, f2, f3, p.idx);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 gv[S];
#pragma unroll
          for (int s = 0; s < S; ++s)
            gv[s] = *reinterpret_cast<const float4*>(G + ((size_t)s * p.kmax + 4 * tx + j) * BM + 4 * ty);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float z[S], g[S], f, f1, f2, f3;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              z[s] = acc[s][i][j];
              g[s] = i == 0 ? gv[s].x : i == 1 ? gv[s].y : i == 2 ? gv[s].z : gv[s].w;
            }
            psci_act(act, z[0], f, f1, f2, f3);
            jet_rule_vjp<S>(z, g, f1, f2, f3, p.idx);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
          }
        }
      }
    }
    if (!PARK) __syncthreads();  // every thread has read its cotangents from G
    if (4 * tx < D) {
      store_tile<S, BM>(G, p.kmax, acc, tx, ty);
      float* dst[S];
#pragma unroll
      for (int s = 0; s < S; ++s) dst[s] = p.gz[l] + (size_t)s * p.N * D;
      store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
    }
    __syncthreads();

    zero_acc<S>(acc);
    tile_matmul_t<S, BM>(acc, G, p.kmax, p.W[l], K, D, Wc, kpad, tx, ty);  // gz @ W^T
    if (4 * tx < K) {
      if (l == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = row0 + 4 * ty + i;
            if (n >= p.N) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * tx + j < K) p.gin[s][(size_t)n * K + 4 * tx + j] = acc[s][i][j];
          }
      } else if (PARK) {
        // park the next layer's output cotangent in its gz buffer (K == dims[l])
        float* dst[S];
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.gz[l - 1] + (size_t)s * p.N * K;
        store_rows<S>(dst, acc, K, row0, p.N, tx, ty);
      } else {
        store_tile<S, BM>(G, p.kmax, acc, tx, ty);
      }
    }
    __syncthreads();
  }
}

template <int S, int BM, bool PARK, bool ANY>
static cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem =
      ((PARK ? 1 : 2) * (size_t)S * p.kmax * BM + (size_t)PSCI_KC * (p.kmax + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_bwd_kernel<S, BM, PARK, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_bwd_kernel<S, BM, PARK, ANY><<<grid, PSCI_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, bool PARK, bool ANY>
static cudaError_t launch_s(const BwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 1: return launch<1, BM, PARK, ANY>(p, st);
    case 2: return launch<2, BM, PARK, ANY>(p, st);
    case 3: return launch<3, BM, PARK, ANY>(p, st);
    case 4: return launch<4, BM, PARK, ANY>(p, st);
    case 5: return launch<5, BM, PARK, ANY>(p, st);
    case 6: return launch<6, BM, PARK, ANY>(p, st);
    case 7: return launch<7, BM, PARK, ANY>(p, st);
    default: return launch<8, BM, PARK, ANY>(p, st);
  }
}

// Host entry point. Pointer arguments are host arrays of device pointers:
// x[S], bounds[L-1], W[L], b[L], gout[S], gin[S], gz[L]; dims[L+1];
// kind/pa/pb[S]. kmax >= every dims[l], rounded up to a multiple of 4.
// bm: rows per tile, 16 (widths <= 256) or 8 (widths <= 512, which always
// parks); park: keep the running cotangent in gz (1) or in shared memory
// (0); act, act_w: the activation's id and parameter. Returns a
// cudaError_t code (0 = launched).
extern "C" int jet_mlp_bwd(const void* const* x, const void* const* bounds, const void* const* W,
                           const void* const* b, const void* const* gout, void* const* gin,
                           void* const* gz, const int* dims, const int* kind, const int* pa,
                           const int* pb, int S, int L, int N, int kmax, int bm, int park, int act,
                           float act_w, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || act < 0 || act >= PSCI_N_ACTS)
    return (int)cudaErrorInvalidValue;
  if (!(bm == PSCI_BM && kmax <= 4 * 64) && !(bm == PSCI_BM_WIDE && kmax <= 4 * 128 && park))
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
  if (bm == PSCI_BM_WIDE) return (int)launch_s<PSCI_BM_WIDE, true, true>(p, S, st);
  if (park) return (int)launch_s<PSCI_BM, true, true>(p, S, st);
  return (int)(act == PSCI_TANH ? launch_s<PSCI_BM, false, false>(p, S, st) : launch_s<PSCI_BM, false, true>(p, S, st));
}

PSCI_ERROR_STRING_FN
