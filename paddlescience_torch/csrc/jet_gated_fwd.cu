// jet_gated_fwd: fused Taylor-jet forward of a gated layer program
// (ModifiedMLP segments, PirateNet block groups).
//
// Replaces paddlescience_tpu/ops/jet_pallas.py::_forward (pallas_call at
// :361) for the bodies arch/mlp.py::_mlp_segment_fn(gated=True) and
// _piratenet_blocks_fn. For each layer l and each of the S jet streams:
// z_s = y_s @ W_l, z_0 += b_l, the jet rule of the segment's activation
// (jet_common.cuh, psci_act), then what the layer's op code asks for:
//   GATE      y <- v + y * (u - v)          (jet product rule with u, v)
//   RESIDUAL  y <- alpha * y + (1 - alpha) * y_in, y_in the stage's input
// Optionally writes the stage boundaries (the carry entering every stage
// but the first) for the backward kernel.
//
// What bounds it on an H100: operations, L*S*2*N*K*D FLOPs in float32
// (58 GFLOP for a PirateNet group of 9 blocks = 27 layers at S=4, N=4096,
// K=D=256: 0.87 ms at the 67 TFLOP/s float32 non-tensor-core peak); the
// y, u, v, output and weight bytes (~90 MB) take 0.03 ms at 3.35 TB/s.
//
// Design: as jet_mlp_fwd.cu, one CTA per 16-row tile keeps the carry of
// all S streams in shared memory for the whole program and each thread a
// 4x4 micro-tile of every stream in registers. u, v and the residual's
// stage input are only ever used elementwise, never as a matmul operand,
// so they get no shared-memory tile: each thread reads its own micro-tile
// of them from device memory (L2) where a gate or residual needs it. A
// stage input that is not the segment input is read back from where the
// same thread wrote it at the end of the previous stage (the boundary
// buffer, or a scratch the wrapper passes when boundaries are not saved).
#include "jet_common.cuh"

struct GatedFwdParams {
  const float* x[PSCI_MAX_S];      // segment input streams, (N, dims[0])
  const float* u[PSCI_MAX_S];      // gate streams, (N, Wuv); unused without gates
  const float* v[PSCI_MAX_S];
  const float* W[PSCI_MAX_L];      // (dims[l], dims[l+1])
  const float* b[PSCI_MAX_L];      // (dims[l+1],)
  const float* alpha[PSCI_MAX_L];  // (1,) for residual layers, else null
  float* out[PSCI_MAX_S];          // segment output streams, (N, dims[L])
  float* lin[PSCI_MAX_L];          // lin[l], l a stage start > 0: (S, N, dims[l]) carry entering it, or null
  int dims[PSCI_MAX_L + 1];
  int op[PSCI_MAX_L];
  int sfirst[PSCI_MAX_L];          // first layer of the stage that holds layer l
  JetIdx idx;
  Act act;
  int L, N, kmax;
};

template <int S, bool ANY>
__global__ void __launch_bounds__(PSCI_THREADS, S <= 4 ? 2 : 1) jet_gated_fwd_kernel(const GatedFwdParams p) {
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                                   // [S][kmax][BM]
  float* Wc = smem + (size_t)S * p.kmax * PSCI_BM;   // [KC][D]
  const int row0 = blockIdx.x * PSCI_BM;
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;

  const float* src[S];
  const float* us[S];
  const float* vs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    src[s] = p.x[s];
    us[s] = p.u[s];
    vs[s] = p.v[s];
  }
  load_tile<S>(A, p.kmax, src, p.dims[0], row0, p.N);
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int K = p.dims[l], D = p.dims[l + 1], op = p.op[l];
    float acc[S][4][4];
    zero_acc<S>(acc);
    tile_matmul<S>(acc, A, p.kmax, p.W[l], K, D, Wc, tx, ty);
    if (4 * tx < D) {
      add_bias<S>(acc, p.b[l], tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) act_jet<S>(acc, p.idx, act, i, j);
      if (op & PSCI_OP_GATE) gate_tile<S>(acc, us, vs, D, row0, p.N, p.idx, tx, ty);
      if (op & PSCI_OP_RESIDUAL) {
        const float a = __ldg(p.alpha[l]);
        const int sf = p.sfirst[l];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          // written by this thread at the end of the previous stage when sf > 0
          const float* q = sf == 0 ? p.x[s] : p.lin[sf] + (size_t)s * p.N * D;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = row0 + 4 * ty + i;
            if (n >= p.N) continue;
            const float4 xin = *(reinterpret_cast<const float4*>(q + (size_t)n * D) + tx);
            acc[s][i][0] = a * acc[s][i][0] + (1.f - a) * xin.x;
            acc[s][i][1] = a * acc[s][i][1] + (1.f - a) * xin.y;
            acc[s][i][2] = a * acc[s][i][2] + (1.f - a) * xin.z;
            acc[s][i][3] = a * acc[s][i][3] + (1.f - a) * xin.w;
          }
        }
      }
      store_tile<S>(A, p.kmax, acc, tx, ty);
      float* dst[S];
      bool write = true;
      if (l == p.L - 1) {
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.out[s];
      } else if ((p.op[l + 1] & PSCI_OP_STAGE) && p.lin[l + 1] != nullptr) {
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.lin[l + 1] + (size_t)s * p.N * D;
      } else {
        write = false;
      }
      if (write) store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
    }
    __syncthreads();
  }
}

template <int S, bool ANY>
static cudaError_t launch(const GatedFwdParams& p, cudaStream_t stream) {
  int dmax = 0;
  for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;
  const size_t smem = ((size_t)S * p.kmax * PSCI_BM + (size_t)PSCI_KC * dmax) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(jet_gated_fwd_kernel<S, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + PSCI_BM - 1) / PSCI_BM);
  jet_gated_fwd_kernel<S, ANY><<<grid, PSCI_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ANY = false: the kernel specialised to tanh (the Allen-Cahn paths'
// activation), with the code and registers of a tanh-only kernel.
template <bool ANY>
static cudaError_t launch_s(const GatedFwdParams& p, int S, cudaStream_t st) {
  switch (S) {
    case 1: return launch<1, ANY>(p, st);
    case 2: return launch<2, ANY>(p, st);
    case 3: return launch<3, ANY>(p, st);
    case 4: return launch<4, ANY>(p, st);
    case 5: return launch<5, ANY>(p, st);
    case 6: return launch<6, ANY>(p, st);
    case 7: return launch<7, ANY>(p, st);
    default: return launch<8, ANY>(p, st);
  }
}

// Host entry point. Pointer arguments are host arrays of device pointers:
// x[S], u[S], v[S] (u, v may be null arrays when no layer is gated), W[L],
// b[L], alpha[L] (null entries for layers without a residual), out[S],
// lin[L] (null entries = do not write). dims[L+1]; op[L]; kind/pa/pb[S];
// act, act_w: the activation's id and parameter. A residual in a stage
// that does not start the segment needs lin[] of that stage's first layer.
// Widths <= 256 (16-row tiles). Returns a cudaError_t code (0 = launched).
extern "C" int jet_gated_fwd(const void* const* x, const void* const* u, const void* const* v,
                             const void* const* W, const void* const* b, const void* const* alpha,
                             void* const* out, void* const* lin, const int* dims, const int* op,
                             const int* kind, const int* pa, const int* pb, int S, int L, int N,
                             int kmax, int act, float act_w, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || kmax > 4 * 64 || act < 0 ||
      act >= PSCI_N_ACTS)
    return (int)cudaErrorInvalidValue;
  if (!(op[0] & PSCI_OP_STAGE)) return (int)cudaErrorInvalidValue;
  GatedFwdParams p = {};
  for (int s = 0; s < S; ++s) {
    p.x[s] = static_cast<const float*>(x[s]);
    p.u[s] = u != nullptr ? static_cast<const float*>(u[s]) : nullptr;
    p.v[s] = v != nullptr ? static_cast<const float*>(v[s]) : nullptr;
    p.out[s] = static_cast<float*>(out[s]);
    p.idx.kind[s] = kind[s];
    p.idx.pa[s] = pa[s];
    p.idx.pb[s] = pb[s];
  }
  int sfirst = 0;
  for (int l = 0; l < L; ++l) {
    if (op[l] & PSCI_OP_STAGE) sfirst = l;
    p.W[l] = static_cast<const float*>(W[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.alpha[l] = static_cast<const float*>(alpha[l]);
    p.lin[l] = static_cast<float*>(lin[l]);
    p.op[l] = op[l];
    p.sfirst[l] = sfirst;
    if ((op[l] & PSCI_OP_GATE) && (u == nullptr || v == nullptr)) return (int)cudaErrorInvalidValue;
    if ((op[l] & PSCI_OP_RESIDUAL) && (alpha[l] == nullptr || (sfirst > 0 && lin[sfirst] == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.act = Act{act, act_w};
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(act == PSCI_TANH ? launch_s<false>(p, S, st) : launch_s<true>(p, S, st));
}

PSCI_ERROR_STRING_FN
