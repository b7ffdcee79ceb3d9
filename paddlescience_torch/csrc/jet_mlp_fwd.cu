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
// What bounds it on an H100: the tensor cores. A segment does L*S*2*N*K*D
// FLOPs, taken as three TF32 products each (3xTF32, float32 accuracy):
// 8.6 GFLOP for S=4, N=4096, L=4, K=D=256 (3 x 8.6 GFLOP at the 495
// TFLOP/s TF32 peak: 0.052 ms) against ~84 MB of stream, boundary and
// weight traffic (0.025 ms at 3.35 TB/s); 37.6 GFLOP for the aneurysm
// MLP's 3 -> 512 x 6 at S=7, N=2048 (0.23 ms). The same FLOPs at the 67
// TFLOP/s float32 rate outside the tensor cores would take 0.13 and 0.56
// ms.
//
// Design: one CTA per row tile holds all S streams of its rows in shared
// memory for the whole segment, so layer-to-layer activations never touch
// device memory (the TPU kernel's VMEM residency). Each layer's product is
// jet_common.cuh's fwd_matmul: mma.sync m16n8k8 in 3xTF32 with the weights
// (up to 1 MB per layer, more than shared memory) streamed from L2 through
// a 3-stage cp.async ring of 16-row chunks shared by all S streams, one
// barrier a chunk; the next layer's first chunks are in flight during the
// epilogue. Up to width 256 the tile is 16 rows, the CTA 8 warps, and a
// warp owns two 16-column m-tiles x two 8-row n-tiles of every stream;
// above, 8 rows (so that 8 streams of 512 columns, 128 KB, still fit
// beside the ring), 16 warps and two m-tiles x one n-tile: one CTA fills
// an SM there, and 16 warps hide the product's latencies better than 8 of
// four m-tiles (20% at the aneurysm on an H100). Either way a thread holds
// all S streams of its 2 x 2 output blocks, so the jet rule for an element
// runs in registers. The activation is a runtime id (a uniform switch);
// the 16-row kernels also come specialised to tanh (ANY = false), the
// Allen-Cahn paths' activation, so that its code and registers are those
// of a tanh-only kernel.
//
// More than PSCI_GROUP_S streams (up to 16: every order <= 2 jet of four
// inputs is 15) would need 16 * S accumulators a thread, more than a
// thread's 255 registers at S = 16. jet_mlp_fwd_halves runs each layer's
// product over the two halves of the streams in turn, with the kernel
// above's product and accumulators of at most 8 streams: a stream's
// product reads only that stream's rows of the tile, so each half's
// pre-activations go back over its own rows, and one more pass over the
// tile applies the jet rule to all S streams of an element, read from
// shared memory. The weights stream from L2 once per half. The tile rows
// come from the shared memory of all S streams (ops/jet_mlp.py::tile_rows).
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
  int L, N, kmax, rs;  // kmax: the tile's row stride; rs: the ring's (fwd_ring_stride)
};

template <int S, int BM, bool ANY>
__global__ void __launch_bounds__(FW_THREADS<BM>, BM == PSCI_BM && S <= 4 ? 2 : 1) jet_mlp_fwd_kernel(const FwdParams p) {
  constexpr int MT = FW_MT<BM>, NT = FW_NT<BM>;
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  float* Y = smem;                                  // [S][BM][kst], swizzled (fwd_at)
  float* ring = smem + (size_t)S * BM * p.kmax;     // FW_STAGES x [PSCI_KC][rs]
  const int row0 = blockIdx.x * BM, kst = p.kmax, rs = p.rs;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  fwd_prologue<BM>(ring, p.W[0], p.dims[0], p.dims[1], rs);
  fwd_load_tile<S, BM>(Y, kst, p.x, p.dims[0], row0, p.N);

  for (int l = 0; l < p.L; ++l) {
    const int D = p.dims[l + 1];
    FwdAcc<S, BM> acc;
    fwd_matmul<S, BM>(acc, Y, kst, p.W[l], p.dims[l], D, ring, rs);
    const bool last = l == p.L - 1;
    if (!last) fwd_prologue<BM>(ring, p.W[l + 1], D, p.dims[l + 2], rs);
    float* dst[S];  // the segment output, a saved boundary, or nowhere (null)
#pragma unroll
    for (int s = 0; s < S; ++s)
      dst[s] = last ? p.out[s] : p.bounds[l] != nullptr ? p.bounds[l] + (size_t)s * p.N * D : nullptr;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = 16 * (warp + FW_WARPS<BM> * i) + 2 * g;  // the thread's columns c, c + 1
      if (c - 2 * g >= D) continue;
      const bool col_ok = c < D;
      float bias[2] = {0.f, 0.f};
      if (col_ok) ldg<2>(p.b[l] + c, bias);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * j + 2 * t + h, n = row0 + r;
          float z[2][S];
          fwd_rule<S, BM>(z, acc, i, j, h, bias, act, p.idx);
          fwd_put<S, BM>(z, Y, kst, r, c, col_ok, last, dst, col_ok && n < p.N, (size_t)n * D + c);
        }
    }
  }
}

// One half of the streams (G of them, the tile's rows from Yh on) through
// layer l's product; their pre-activations (no bias) back into the same
// rows of the tile, columns past the layer's width (to the m-tile's end)
// zero.
template <int G, int BM>
__device__ __forceinline__ void fwd_half(float* Yh, const FwdParams& p, int l, float* ring) {
  constexpr int MT = FW_MT<BM>, NT = FW_NT<BM>;
  const int D = p.dims[l + 1], kst = p.kmax;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FwdAcc<G, BM> acc;
  fwd_matmul<G, BM>(acc, Yh, kst, p.W[l], p.dims[l], D, ring, p.rs);  // ends with a barrier: Yh may be written
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int c = 16 * (warp + FW_WARPS<BM> * i) + 2 * g;  // the thread's columns c, c + 1
    if (c - 2 * g >= D) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * j + 2 * t + h;
#pragma unroll
        for (int s = 0; s < G; ++s) {
          const float v[2] = {acc[i][j][s][h], acc[i][j][s][2 + h]};
          st<2>(Yh + fwd_at<BM>(s, r, c, kst), v);
        }
      }
  }
}

template <int S, int BM>
__global__ void __launch_bounds__(FW_THREADS<BM>, 1) jet_mlp_fwd_halves(const FwdParams p) {
  constexpr int G0 = (S + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  float* Y = smem;                                  // [S][BM][kst], swizzled (fwd_at)
  float* ring = smem + (size_t)S * BM * p.kmax;     // FW_STAGES x [PSCI_KC][rs]
  const int row0 = blockIdx.x * BM, kst = p.kmax;

  fwd_prologue<BM>(ring, p.W[0], p.dims[0], p.dims[1], p.rs);
  fwd_load_tile<S, BM>(Y, kst, p.x, p.dims[0], row0, p.N);

  for (int l = 0; l < p.L; ++l) {
    const int D = p.dims[l + 1];
    const bool last = l == p.L - 1;
    fwd_half<G0, BM>(Y, p, l, ring);
    fwd_prologue<BM>(ring, p.W[l], p.dims[l], D, p.rs);
    fwd_half<S - G0, BM>(Y + (size_t)G0 * BM * kst, p, l, ring);
    if (!last) fwd_prologue<BM>(ring, p.W[l + 1], D, p.dims[l + 2], p.rs);
    __syncthreads();  // every stream's pre-activations are in the tile
    // the jet rule on element (r, c) of every stream; columns from D to the
    // next multiple of 8 (the next layer's last k-step) become zero
    const int D8 = (D + 7) & ~7;
    for (int e = threadIdx.x; e < BM * D8; e += FW_THREADS<BM>) {
      const int r = e / D8, c = e - r * D8, n = row0 + r;
      float z[S];
#pragma unroll
      for (int s = 0; s < S; ++s) z[s] = Y[fwd_at<BM>(s, r, c, kst)];
      if (c < D) {
        z[0] += __ldg(p.b[l] + c);
        float f, f1, f2, f3;
        psci_act(p.act, z[0], f, f1, f2, f3);
        jet_rule_elem<S>(z, f, f1, f2, p.idx);
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) z[s] = 0.f;
      }
      if (!last) {
#pragma unroll
        for (int s = 0; s < S; ++s) Y[fwd_at<BM>(s, r, c, kst)] = z[s];
      }
      float* dst = last ? p.out[0] : p.bounds[l];  // the segment output, a saved boundary, or nowhere
      if (dst != nullptr && c < D && n < p.N) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float* d = last ? p.out[s] + (size_t)n * D : p.bounds[l] + ((size_t)s * p.N + n) * D;
          d[c] = z[s];
        }
      }
    }
    // no barrier: the next layer's product publishes the tile before any thread reads it
  }
}

template <int S, int BM>
static cudaError_t launch_halves(const FwdParams& p, cudaStream_t stream) {
  int dmax = 0;
  for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;
  const size_t smem = fwd_smem(S, p.kmax, BM, dmax);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_fwd_halves<S, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_fwd_halves<S, BM><<<grid, FW_THREADS<BM>, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int S, int BM, bool ANY>
static cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  int dmax = 0;
  for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;
  const size_t smem = fwd_smem(S, p.kmax, BM, dmax);
  cudaError_t err = cudaFuncSetAttribute(jet_mlp_fwd_kernel<S, BM, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BM - 1) / BM);
  jet_mlp_fwd_kernel<S, BM, ANY><<<grid, FW_THREADS<BM>, smem, stream>>>(p);
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

// More than PSCI_GROUP_S streams, any activation.
template <int BM>
static cudaError_t launch_halves_s(const FwdParams& p, int S, cudaStream_t st) {
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
// x[S], W[L], b[L], out[S], bounds[L-1] (bounds may be null = do not save).
// dims[L+1]; kind/pa/pb[S]. kmax: the tile's row stride, the widest layer
// rounded up to 32; bm: rows per tile, 16 (every width <= 256) or 8
// (widths <= 512; above PSCI_GROUP_S streams, whichever holds the S-stream
// tile: ops/jet_mlp.py::tile_rows); act, act_w: the activation's id and
// parameter.
// Returns a cudaError_t code (0 = launched).
extern "C" int jet_mlp_fwd(const void* const* x, const void* const* W, const void* const* b,
                           void* const* out, void* const* bounds, const int* dims,
                           const int* kind, const int* pa, const int* pb, int S, int L, int N,
                           int kmax, int bm, int act, float act_w, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || act < 0 || act >= PSCI_N_ACTS)
    return (int)cudaErrorInvalidValue;
  if ((!(bm == PSCI_BM && kmax <= 256) && !(bm == PSCI_BM_WIDE && kmax <= 512)) || kmax % 32)
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
  int dmax = 0;
  for (int l = 0; l <= L; ++l) {
    if (dims[l] < 1 || dims[l] > kmax || (l > 0 && dims[l] % 4)) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    if (l > 0 && dims[l] > dmax) dmax = dims[l];
  }
  p.act = Act{act, act_w};
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  p.rs = fwd_ring_stride(dmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > PSCI_GROUP_S)
    return (int)(bm == PSCI_BM_WIDE ? launch_halves_s<PSCI_BM_WIDE>(p, S, st) : launch_halves_s<PSCI_BM>(p, S, st));
  if (bm == PSCI_BM_WIDE) return (int)launch_s<PSCI_BM_WIDE, true>(p, S, st);
  return (int)(act == PSCI_TANH ? launch_s<PSCI_BM, false>(p, S, st) : launch_s<PSCI_BM, true>(p, S, st));
}

PSCI_ERROR_STRING_FN
