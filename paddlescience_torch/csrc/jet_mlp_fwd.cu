// jet_mlp_fwd: fused Taylor-jet forward of an ungated MLP segment.
//
// Replaces paddlescience_tpu/ops/jet_pallas.py::_forward (pallas_call at
// :361) for the MLP body arch/mlp.py::_mlp_segment_fn. For each layer l and
// each of the S jet streams: z_s = y_s @ W_l, z_0 += b_l, then the
// closed-form jet rule of the segment's activation f (jet_common.cuh,
// psci_act: every stateless activation of the JAX package and Siren)
//   y_0 = f(z_0),  y_k = f'(z_0) z_k,  y_ij = f''(z_0) z_i z_j + f'(z_0) z_ij.
// Optionally writes the stage boundaries (the jets entering layers 1..L-1)
// for the backward kernel.
//
// What bounds it on an H100: operations. A segment does L*S*2*N*K*D FLOPs
// in float32: 8.6 GFLOP for S=4, N=4096, L=4, K=D=256 (0.13 ms at the
// 67 TFLOP/s float32 non-tensor-core peak) against ~84 MB of stream,
// boundary and weight traffic (0.025 ms at 3.35 TB/s); 37.6 GFLOP for the
// aneurysm MLP's five 512-wide layers at S=7, N=2048 (0.56 ms).
//
// Design: one CTA per row tile holds all S streams of its rows in shared
// memory for the whole segment, so layer-to-layer activations never touch
// device memory (the TPU kernel's VMEM residency). Weights (up to 1 MB per
// layer in float32, more than shared memory) stream from L2 in chunks of
// 16 rows shared by all S streams. Each thread keeps a 4x4 micro-tile of
// every stream in registers (S*16 accumulators), so the jet rule for an
// element finds all its streams in one thread. Up to width 256 the tile is
// 16 rows (64 threads across the columns); above, 8 rows (128 across), so
// that 8 streams of 512 columns (128 KB) still fit with a weight chunk.
// The activation is a runtime id (a uniform switch); the 16-row kernels
// also come specialised to tanh (ANY = false), the Allen-Cahn paths'
// activation, so that its code and registers are those of a tanh-only
// kernel. Plain FP32 FFMA, no tensor cores: the port's reference precision
// is true float32.
#include "jet_common.cuh"

struct FwdParams {
  const float* x[PSCI_MAX_S];  // segment input streams, (N, dims[0])
  const float* W[PSCI_MAX_L];  // (dims[l], dims[l+1])
  const float* b[PSCI_MAX_L];  // (dims[l+1],)
  float* out[PSCI_MAX_S];      // segment output streams, (N, dims[L])
  float* bounds[PSCI_MAX_L];   // bounds[l]: (S, N, dims[l+1]) entering layer l+1, or null
  int dims[PSCI_MAX_L + 1];
  JetIdx idx;
  Act act;
  int L, N, kmax;
};

template <int S, int BM, bool ANY>
__global__ void __launch_bounds__(PSCI_THREADS, S <= 4 ? 2 : 1) jet_mlp_fwd_kernel(const FwdParams p) {
  constexpr int TX = 4 * PSCI_THREADS / BM;
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                              // [S][kmax][BM]
  float* Wc = smem + (size_t)S * p.kmax * BM;   // [KC][D]
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  const float* src[S];
#pragma unroll
  for (int s = 0; s < S; ++s) src[s] = p.x[s];
  load_tile<S, BM>(A, p.kmax, src, p.dims[0], row0, p.N);
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    float acc[S][4][4];
    zero_acc<S>(acc);
    tile_matmul<S, BM>(acc, A, p.kmax, p.W[l], K, D, Wc, tx, ty);
    if (4 * tx < D) {
      add_bias<S>(acc, p.b[l], tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) act_jet<S>(acc, p.idx, act, i, j);
      store_tile<S, BM>(A, p.kmax, acc, tx, ty);
      float* dst[S];
      bool write = true;
      if (l == p.L - 1) {
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.out[s];
      } else if (p.bounds[l] != nullptr) {
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.bounds[l] + (size_t)s * p.N * D;
      } else {
        write = false;
      }
      if (write) store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
    }
    __syncthreads();
  }
}

template <int S, int BM, bool ANY>
static cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  int dmax = 0;
  for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;
  const size_t smem = ((size_t)S * p.kmax * BM + (size_t)PSCI_KC * dmax) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_fwd_kernel<S, BM, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_fwd_kernel<S, BM, ANY><<<grid, PSCI_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, bool ANY>
static cudaError_t launch_s(const FwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 1: return launch<1, BM, ANY>(p, st);
    case 2: return launch<2, BM, ANY>(p, st);
    case 3: return launch<3, BM, ANY>(p, st);
    case 4: return launch<4, BM, ANY>(p, st);
    case 5: return launch<5, BM, ANY>(p, st);
    case 6: return launch<6, BM, ANY>(p, st);
    case 7: return launch<7, BM, ANY>(p, st);
    default: return launch<8, BM, ANY>(p, st);
  }
}

// Host entry point. Pointer arguments are host arrays of device pointers:
// x[S], W[L], b[L], out[S], bounds[L-1] (bounds may be null = do not save).
// dims[L+1]; kind/pa/pb[S]. bm: rows per tile, 16 (every width <= 256) or
// 8 (widths <= 512); act, act_w: the activation's id and parameter.
// Returns a cudaError_t code (0 = launched).
extern "C" int jet_mlp_fwd(const void* const* x, const void* const* W, const void* const* b,
                           void* const* out, void* const* bounds, const int* dims,
                           const int* kind, const int* pa, const int* pb, int S, int L, int N,
                           int kmax, int bm, int act, float act_w, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || act < 0 || act >= PSCI_N_ACTS)
    return (int)cudaErrorInvalidValue;
  if (!(bm == PSCI_BM && kmax <= 4 * 64) && !(bm == PSCI_BM_WIDE && kmax <= 4 * 128))
    return (int)cudaErrorInvalidValue;
  FwdParams p = {};
  for (int s = 0; s < S; ++s) {
    p.x[s] = static_cast<const float*>(x[s]);
    p.out[s] = static_cast<float*>(out[s]);
    p.idx.kind[s] = kind[s];
    p.idx.pa[s] = pa[s];
    p.idx.pb[s] = pb[s];
  }
  for (int l = 0; l < L; ++l) {
    p.W[l] = static_cast<const float*>(W[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.bounds[l] = (bounds != nullptr && l < L - 1) ? static_cast<float*>(bounds[l]) : nullptr;
  }
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.act = Act{act, act_w};
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == PSCI_BM_WIDE) return (int)launch_s<PSCI_BM_WIDE, true>(p, S, st);
  return (int)(act == PSCI_TANH ? launch_s<PSCI_BM, false>(p, S, st) : launch_s<PSCI_BM, true>(p, S, st));
}

PSCI_ERROR_STRING_FN
