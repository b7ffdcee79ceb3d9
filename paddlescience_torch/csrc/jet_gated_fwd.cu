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
// What bounds it on an H100: the tensor cores. The products are
// L*S*2*N*K*D FLOPs (58 GFLOP for a PirateNet group of 9 blocks = 27
// layers at S=4, N=4096, K=D=256), taken as three TF32 products each
// (3xTF32, float32 accuracy): 3 x 58 GFLOP at the 495 TFLOP/s TF32 peak is
// 0.35 ms, against 0.87 ms for the same FLOPs at the 67 TFLOP/s float32
// rate outside the tensor cores; the y, u, v, output and weight bytes
// (~90 MB) take 0.03 ms at 3.35 TB/s. Weights stream from L2 once per
// 16-row tile and layer (1.8 GB a PirateNet call).
//
// Design: one CTA of 8 warps per 16-row tile keeps the carry of all S
// streams in shared memory for the whole program (the TPU kernel's VMEM
// residency). Each layer's product is jet_common.cuh's fwd_matmul:
// mma.sync m16n8k8 in 3xTF32, the weights through a 3-stage cp.async ring
// with one barrier a chunk, conflict-free fragment loads. Warp w owns the
// 16-column m-tiles w and w + 8 of every stream and row, so a thread holds
// all S streams of its 2 x 2 output blocks and the jet rule, the gate and
// the residual run in registers. The next layer's first weight chunks are
// in flight during the epilogue. u, v and the residual's stage input are
// read at the thread's own elements, 8 bytes a row from device memory (L2;
// every 32-byte sector read whole); a stage input that is not the segment
// input is read back from where the same thread wrote it at the end of
// the previous stage (the boundary buffer, or a scratch the wrapper
// passes when boundaries are not saved). Up to 4 streams two CTAs share an
// SM (115,456 bytes of shared memory each at width 256).
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
  int L, N, kmax, rs;  // kmax: the tile's row stride; rs: the ring's (fwd_ring_stride)
};

template <int S, bool ANY>
__global__ void __launch_bounds__(FW_THREADS<PSCI_BM>, S <= 4 ? 2 : 1) jet_gated_fwd_kernel(const GatedFwdParams p) {
  constexpr int BM = PSCI_BM, MT = FW_MT<BM>, NT = FW_NT<BM>;
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  float* Y = smem;                                  // [S][BM][kst], swizzled (fwd_at)
  float* ring = smem + (size_t)S * BM * p.kmax;     // FW_STAGES x [PSCI_KC][rs]
  const int row0 = blockIdx.x * BM, kst = p.kmax, rs = p.rs;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  fwd_prologue<BM>(ring, p.W[0], p.dims[0], p.dims[1], rs);
  fwd_load_tile<S, BM>(Y, kst, p.x, p.dims[0], row0, p.N);

  for (int l = 0; l < p.L; ++l) {
    const int D = p.dims[l + 1], op = p.op[l];
    FwdAcc<S, BM> acc;
    fwd_matmul<S, BM>(acc, Y, kst, p.W[l], p.dims[l], D, ring, rs);
    const bool last = l == p.L - 1;
    if (!last) fwd_prologue<BM>(ring, p.W[l + 1], D, p.dims[l + 2], rs);
    // where the layer's output goes in device memory: the segment output,
    // or the boundary of the stage that starts next, or nowhere (null)
    float* const next = !last && (p.op[l + 1] & PSCI_OP_STAGE) ? p.lin[l + 1] : nullptr;
    float* dst[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dst[s] = last ? p.out[s] : next != nullptr ? next + (size_t)s * p.N * D : nullptr;
    const float a = (op & PSCI_OP_RESIDUAL) ? __ldg(p.alpha[l]) : 0.f;
    const int sf = p.sfirst[l];
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
          const bool ok = col_ok && n < p.N;
          const size_t e = (size_t)n * D + c;
          float z[2][S];
          fwd_rule<S, BM>(z, acc, i, j, h, bias, act, p.idx);
          if (op & PSCI_OP_GATE) {
            float u[2][S], v[2][S];
#pragma unroll
            for (int s = 0; s < S; ++s) {
              float uu[2] = {0.f, 0.f}, vv[2] = {0.f, 0.f};
              if (ok) {
                ldg<2>(p.u[s] + e, uu);
                ldg<2>(p.v[s] + e, vv);
              }
              u[0][s] = uu[0], u[1][s] = uu[1], v[0][s] = vv[0], v[1][s] = vv[1];
            }
            gate_jet_elem<S>(z[0], u[0], v[0], p.idx);
            gate_jet_elem<S>(z[1], u[1], v[1], p.idx);
          }
          if (op & PSCI_OP_RESIDUAL) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
              // written by this thread at the end of the previous stage when sf > 0
              const float* q = sf == 0 ? p.x[s] : p.lin[sf] + (size_t)s * p.N * D;
              float xin[2] = {0.f, 0.f};
              if (ok) ld<2>(q + e, xin);
              z[0][s] = a * z[0][s] + (1.f - a) * xin[0];
              z[1][s] = a * z[1][s] + (1.f - a) * xin[1];
            }
          }
          fwd_put<S, BM>(z, Y, kst, r, c, col_ok, last, dst, ok, e);
        }
    }
  }
}


template <int S, bool ANY>
static cudaError_t launch(const GatedFwdParams& p, cudaStream_t stream) {
  int dmax = 0;
  for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;
  const size_t smem = fwd_smem(S, p.kmax, PSCI_BM, dmax);
  cudaError_t err = cudaFuncSetAttribute(jet_gated_fwd_kernel<S, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + PSCI_BM - 1) / PSCI_BM);
  jet_gated_fwd_kernel<S, ANY><<<grid, FW_THREADS<PSCI_BM>, smem, stream>>>(p);
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
// kmax: the tile's row stride, the widest layer rounded up to 32 (<= 256:
// 16-row tiles). Returns a cudaError_t code (0 = launched).
extern "C" int jet_gated_fwd(const void* const* x, const void* const* u, const void* const* v,
                             const void* const* W, const void* const* b, const void* const* alpha,
                             void* const* out, void* const* lin, const int* dims, const int* op,
                             const int* kind, const int* pa, const int* pb, int S, int L, int N,
                             int kmax, int act, float act_w, void* stream) {
  if (S < 1 || S > PSCI_GATED_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || kmax > 256 || kmax % 32 || act < 0 ||
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
  return (int)(act == PSCI_TANH ? launch_s<false>(p, S, st) : launch_s<true>(p, S, st));
}

PSCI_ERROR_STRING_FN
