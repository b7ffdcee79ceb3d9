// jet_mlp_bwd: staged backward of the fused tanh-MLP jet segment, per row
// tile.
//
// Replaces the per-tile part of paddlescience_tpu/ops/jet_pallas.py::_bwd
// (pallas_call at :557, with _staged_vjp :410-485): walk the layers in
// reverse from the saved (or freshly recomputed) stage boundary y_in, and
// for each layer
//   1. recompute z_s = y_in_s @ W (+ b on the primal),
//   2. form the pre-activation cotangents by the hand-derived VJP of the
//      tanh jet rule (t = tanh z_0, sp = 1 - t^2, spp = -2 t sp,
//      sppp = -2 sp^2 + 4 t^2 sp):
//        gz_0  = sp g_0 + spp sum_k g_k z_k
//                + sum_ij (sppp z_i z_j + spp z_ij) g_ij
//        gz_k  = sp g_k + sum_{pairs ij containing k} spp g_ij z_other
//                (the pair (k,k) contributes 2 spp g_kk z_k)
//        gz_ij = sp g_ij,
//   3. write gz for the weight gradient (jet_wgrad.cu),
//   4. propagate g_yin_s = gz_s @ W^T; after layer 0 these are the
//      cotangents of the segment's input streams.
// The weight gradient's sum over the batch is jet_wgrad's job: on the TPU
// the sequential grid carried it, here the CTAs run in no order.
//
// What bounds it on an H100: operations, 2*L*S*2*N*K*D FLOPs in float32
// (17.2 GFLOP at S=4, N=4096, L=4, K=D=256: 0.26 ms at 67 TFLOP/s) against
// ~170 MB of boundary, cotangent and gz traffic (0.05 ms at 3.35 TB/s).
//
// Design: one CTA per 16-row tile keeps the layer input A and the running
// cotangent G of all S streams in shared memory (2 * S * 256 * 16 floats);
// weights stream from L2 in 16-row (forward product) or 16-column
// (transposed product) chunks. Micro-tiles as in jet_mlp_fwd.cu.
#include "jet_common.cuh"

struct BwdParams {
  const float* x[PSCI_MAX_S];        // segment input streams, (N, dims[0])
  const float* bounds[PSCI_MAX_L];   // bounds[l]: (S, N, dims[l+1]) entering layer l+1
  const float* W[PSCI_MAX_L];
  const float* b[PSCI_MAX_L];
  const float* gout[PSCI_MAX_S];     // cotangents of the segment outputs, (N, dims[L])
  float* gin[PSCI_MAX_S];            // cotangents of the segment inputs, (N, dims[0])
  float* gz[PSCI_MAX_L];             // gz[l]: (S, N, dims[l+1])
  int dims[PSCI_MAX_L + 1];
  JetIdx idx;
  int L, N, kmax;
};

template <int S>
__device__ __forceinline__ void tanh_jet_vjp(float (&z)[S], const float (&g)[S], const JetIdx& idx) {
  const float t = tanhf(z[0]);
  const float sp = 1.f - t * t;
  const float spp = -2.f * t * sp;
  const float sppp = -2.f * sp * sp + 4.f * t * t * sp;
  float gz[S];
  gz[0] = sp * g[0];
#pragma unroll
  for (int s = 1; s < S; ++s) {
    gz[s] = sp * g[s];
    if (idx.kind[s] == 1) {
      gz[0] += spp * g[s] * z[s];
    } else {
      const float za = sel<S>(z, idx.pa[s]), zb = sel<S>(z, idx.pb[s]);
      gz[0] += (sppp * za * zb + spp * z[s]) * g[s];
      add_at<S>(gz, idx.pa[s], spp * g[s] * zb);
      add_at<S>(gz, idx.pb[s], spp * g[s] * za);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = gz[s];
}

template <int S>
__global__ void __launch_bounds__(PSCI_THREADS, 1) jet_mlp_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const size_t tile = (size_t)S * p.kmax * PSCI_BM;
  float* A = smem;             // layer input y_in, [S][kmax][BM]
  float* G = smem + tile;      // running cotangent, [S][kmax][BM]
  float* Wc = smem + 2 * tile; // weight chunk
  const int kpad = p.kmax + 4;
  const int row0 = blockIdx.x * PSCI_BM;
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;

  {
    const float* src[S];
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = p.gout[s];
    load_tile<S>(G, p.kmax, src, p.dims[p.L], row0, p.N);
  }

  for (int l = p.L - 1; l >= 0; --l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    {
      const float* src[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        src[s] = (l == 0) ? p.x[s] : p.bounds[l - 1] + (size_t)s * p.N * K;
      load_tile<S>(A, p.kmax, src, K, row0, p.N);
    }
    __syncthreads();

    float acc[S][4][4];
    zero_acc<S>(acc);
    tile_matmul<S>(acc, A, p.kmax, p.W[l], K, D, Wc, tx, ty);  // z
    if (4 * tx < D) {
      add_bias<S>(acc, p.b[l], tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 gv[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          gv[s] = *reinterpret_cast<const float4*>(G + ((size_t)s * p.kmax + 4 * tx + j) * PSCI_BM + 4 * ty);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float z[S], g[S];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            z[s] = acc[s][i][j];
            g[s] = i == 0 ? gv[s].x : i == 1 ? gv[s].y : i == 2 ? gv[s].z : gv[s].w;
          }
          tanh_jet_vjp<S>(z, g, p.idx);
#pragma unroll
          for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
        }
      }
    }
    __syncthreads();  // every thread has read its cotangents from G
    if (4 * tx < D) {
      store_tile<S>(G, p.kmax, acc, tx, ty);
      float* dst[S];
#pragma unroll
      for (int s = 0; s < S; ++s) dst[s] = p.gz[l] + (size_t)s * p.N * D;
      store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
    }
    __syncthreads();

    zero_acc<S>(acc);
    tile_matmul_t<S>(acc, G, p.kmax, p.W[l], K, D, Wc, kpad, tx, ty);  // gz @ W^T
    if (4 * tx < K) {
      store_tile<S>(G, p.kmax, acc, tx, ty);
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
      }
    }
    __syncthreads();
  }
}

template <int S>
static cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem =
      (2 * (size_t)S * p.kmax * PSCI_BM + (size_t)PSCI_KC * (p.kmax + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_bwd_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + PSCI_BM - 1) / PSCI_BM);
  jet_mlp_bwd_kernel<S><<<grid, PSCI_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Host entry point. Pointer arguments are host arrays of device pointers:
// x[S], bounds[L-1], W[L], b[L], gout[S], gin[S], gz[L]; dims[L+1];
// kind/pa/pb[S]. kmax >= every dims[l], rounded up to a multiple of 4.
// Returns a cudaError_t code (0 = launched).
extern "C" int jet_mlp_bwd(const void* const* x, const void* const* bounds, const void* const* W,
                           const void* const* b, const void* const* gout, void* const* gin,
                           void* const* gz, const int* dims, const int* kind, const int* pa,
                           const int* pb, int S, int L, int N, int kmax, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1) return (int)cudaErrorInvalidValue;
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
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)launch<1>(p, st);
    case 2: return (int)launch<2>(p, st);
    case 3: return (int)launch<3>(p, st);
    case 4: return (int)launch<4>(p, st);
    case 5: return (int)launch<5>(p, st);
    case 6: return (int)launch<6>(p, st);
    case 7: return (int)launch<7>(p, st);
    default: return (int)launch<8>(p, st);
  }
}

PSCI_ERROR_STRING_FN
