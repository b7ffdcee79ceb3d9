// jet_gated_bwd: staged backward of a gated layer program (ModifiedMLP
// segments, PirateNet block groups), per row tile.
//
// Replaces the per-tile part of paddlescience_tpu/ops/jet_pallas.py::_bwd
// (pallas_call at :557, with _staged_vjp :410-485) for the bodies
// arch/mlp.py::_mlp_segment_fn(gated=True) and _piratenet_blocks_fn. The
// TPU kernel differentiates the stage function at trace time; here the VJP
// is derived by hand. Stages are walked in reverse from the saved (or
// freshly recomputed) stage boundaries. For each stage:
//   1. forward phase: recompute the stage's inner layers from its boundary
//      (z_s = y_in_s @ W (+ b on the primal), the activation's jet rule,
//      gate); write
//      each layer's output, the next layer's input, to device memory for
//      jet_wgrad.cu, and park its z in the layer's gz buffer;
//   2. reverse phase, per layer from the stage's last: take z back from the
//      gz buffer (the stage's last layer computes it here, from the input
//      the forward phase left in shared memory) and f = act-jet(z); then,
//      with g the cotangent of the layer's output,
//      RESIDUAL (out = alpha f + (1 - alpha) y_stage_in):
//        d alpha += sum_s g_s (f_s - y_stage_in_s),
//        g_res = (1 - alpha) g   (parked in the g_y buffer until the
//                                 stage's first layer has been passed),
//        g <- alpha g;
//      GATE (out = v + f d, d = u - v; jet product rule):
//        g_f0 = sum_s g_s d_s,   g_d0 = sum_s g_s f_s,
//        g_fk = g_k d_0 + sum_{pairs ij containing k} g_ij d_other,
//        g_dk = g_k f_0 + sum_{pairs ij containing k} g_ij f_other,
//        g_fij = g_ij d_0,       g_dij = g_ij f_0,
//        g_u += g_d,  g_v += g - g_d,  g <- g_f;
//      the activation's jet rule: gz from (z, g) (jet_common.cuh,
//      jet_rule_vjp) as in jet_mlp_bwd.cu;
//      write gz; g <- gz @ W^T; at the stage's first layer add g_res.
// The sums over the batch (dW, db and d alpha) are jet_wgrad.cu's, one
// launch: this kernel writes gz, the layer inputs and one partial d alpha
// per CTA and residual.
//
// What bounds it on an H100: operations. Per layer 2 products, z once and
// gz @ W^T once: a PirateNet group of 9 blocks at S=4, N=4096, K=D=256 does
// 2*27*S*2*N*K*D = 116 GFLOP in float32, 1.7 ms at 67 TFLOP/s, against
// ~1.1 GB of boundary, gz, layer-input and gate-cotangent traffic (0.33 ms
// at 3.35 TB/s) and 0.6 GB more for parking z (not part of the bound).
//
// Design: as jet_mlp_bwd.cu, one CTA per 16-row tile holds the layer input
// A and the running cotangent G of all S streams in shared memory
// (2 * S * 256 * 16 floats), weights stream from L2. u, v, the residual's
// stage input and the g_u, g_v sums are elementwise only: each thread
// reads and updates its own micro-tile of them in device memory, so no
// atomics and a fixed summation order. d alpha is reduced over the CTA by
// warp shuffles and a fixed-order sum over the 8 warps.
#include "jet_common.cuh"

struct GatedBwdParams {
  const float* x[PSCI_MAX_S];      // segment input streams, (N, dims[0])
  const float* u[PSCI_MAX_S];      // gate streams (N, Wuv); unused without gates
  const float* v[PSCI_MAX_S];
  const float* gout[PSCI_MAX_S];   // cotangents of the segment outputs, (N, dims[L])
  float* gin[PSCI_MAX_S];          // cotangents of the segment inputs, (N, dims[0])
  float* gu[PSCI_MAX_S];           // cotangents of u, v
  float* gv[PSCI_MAX_S];
  const float* W[PSCI_MAX_L];
  const float* b[PSCI_MAX_L];
  const float* alpha[PSCI_MAX_L];  // (1,) for residual layers
  float* lin[PSCI_MAX_L];          // lin[l], l > 0: (S, N, dims[l]) input of layer l: given for a stage's
                                   // first layer (the boundary), written here for inner layers
  float* gz[PSCI_MAX_L];           // gz[l]: (S, N, dims[l+1]); holds z of an inner layer between the phases
  float* apart;                    // [gridDim.x][n_res] partial d alpha
  int dims[PSCI_MAX_L + 1];
  int op[PSCI_MAX_L];
  int sfirst[PSCI_MAX_L];          // first layer of the stage that holds layer l
  int aidx[PSCI_MAX_L];            // ordinal of a residual layer among the residuals
  JetIdx idx;
  Act act;
  int L, N, kmax, n_res;
};

// One element of one layer in the reverse phase: z holds the recomputed
// pre-activations on entry and the pre-activation cotangents on exit; g the
// cotangent of the layer's output. n, c: the element's row and column;
// ok: the row is inside the batch.
template <int S>
__device__ __forceinline__ void layer_vjp_elem(float (&z)[S], float (&g)[S], const GatedBwdParams& p,
                                               const Act act, int op, float a, const float* const (&xin)[S],
                                               bool first_gate, size_t off, bool ok, float& asum) {
  const JetIdx& idx = p.idx;
  float f0, f1, f2, f3;
  psci_act(act, z[0], f0, f1, f2, f3);
  if (op & (PSCI_OP_GATE | PSCI_OP_RESIDUAL)) {
    float f[S];
#pragma unroll
    for (int s = 0; s < S; ++s) f[s] = z[s];
    jet_rule_elem<S>(f, f0, f1, f2, idx);
    if (op & PSCI_OP_RESIDUAL) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float xs = ok ? __ldg(xin[s] + off) : 0.f;
        asum += g[s] * (f[s] - xs);
        if (ok) p.gin[s][off] = (1.f - a) * g[s];
        g[s] *= a;
      }
    }
    if (op & PSCI_OP_GATE) {
      float d[S], gf[S], gd[S];
#pragma unroll
      for (int s = 0; s < S; ++s) d[s] = ok ? __ldg(p.u[s] + off) - __ldg(p.v[s] + off) : 0.f;
      gf[0] = 0.f;
      gd[0] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        gf[0] += g[s] * d[s];
        gd[0] += g[s] * f[s];
      }
#pragma unroll
      for (int s = 1; s < S; ++s) {
        gf[s] = g[s] * d[0];
        gd[s] = g[s] * f[0];
      }
#pragma unroll
      for (int s = 1; s < S; ++s) {
        if (idx.kind[s] == 2) {
          const int ia = idx.pa[s], ib = idx.pb[s];
          add_at<S>(gf, ia, g[s] * sel<S>(d, ib));
          add_at<S>(gf, ib, g[s] * sel<S>(d, ia));
          add_at<S>(gd, ia, g[s] * sel<S>(f, ib));
          add_at<S>(gd, ib, g[s] * sel<S>(f, ia));
        }
      }
      if (ok) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          // this thread alone owns the element: a plain read-modify-write
          if (first_gate) {
            p.gu[s][off] = gd[s];
            p.gv[s][off] = g[s] - gd[s];
          } else {
            p.gu[s][off] += gd[s];
            p.gv[s][off] += g[s] - gd[s];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) g[s] = gf[s];
    }
  }
  jet_rule_vjp<S>(z, g, f1, f2, f3, idx);  // VJP of the activation's jet rule
}

template <int S, bool ANY>
__global__ void __launch_bounds__(PSCI_THREADS, 1) jet_gated_bwd_kernel(const GatedBwdParams p) {
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[PSCI_THREADS / 32];
  const size_t tile = (size_t)S * p.kmax * PSCI_BM;
  float* A = smem;             // layer input y_in, [S][kmax][BM]
  float* G = smem + tile;      // running cotangent, [S][kmax][BM]
  float* Wc = smem + 2 * tile; // weight chunk
  const int kpad = p.kmax + 4;
  const int row0 = blockIdx.x * PSCI_BM;
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;

  const float* us[S];
  const float* vs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    us[s] = p.u[s];
    vs[s] = p.v[s];
  }
  {
    const float* src[S];
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = p.gout[s];
    load_tile<S>(G, p.kmax, src, p.dims[p.L], row0, p.N);
  }
  bool first_gate = true;

  for (int l1 = p.L - 1; l1 >= 0;) {  // l1: last layer of the current stage
    const int l0 = p.sfirst[l1];
    const float* stage_in[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      stage_in[s] = (l0 == 0) ? p.x[s] : p.lin[l0] + (size_t)s * p.N * p.dims[l0];

    // ---- forward phase: the inputs of the stage's inner layers
    if (l0 < l1) {
      load_tile<S>(A, p.kmax, stage_in, p.dims[l0], row0, p.N);
      __syncthreads();
      for (int m = l0; m < l1; ++m) {
        const int K = p.dims[m], D = p.dims[m + 1];
        float acc[S][4][4];
        zero_acc<S>(acc);
        tile_matmul<S>(acc, A, p.kmax, p.W[m], K, D, Wc, tx, ty);
        if (4 * tx < D) {
          add_bias<S>(acc, p.b[m], tx);
          float* dst[S];
#pragma unroll
          for (int s = 0; s < S; ++s) dst[s] = p.gz[m] + (size_t)s * p.N * D;
          store_rows<S>(dst, acc, D, row0, p.N, tx, ty);  // z, for the reverse phase
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) act_jet<S>(acc, p.idx, act, i, j);
          if (p.op[m] & PSCI_OP_GATE) gate_tile<S>(acc, us, vs, D, row0, p.N, p.idx, tx, ty);
          store_tile<S>(A, p.kmax, acc, tx, ty);
#pragma unroll
          for (int s = 0; s < S; ++s) dst[s] = p.lin[m + 1] + (size_t)s * p.N * D;
          store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
        }
        __syncthreads();
      }
    }

    // ---- reverse phase
    for (int m = l1; m >= l0; --m) {
      const int K = p.dims[m], D = p.dims[m + 1], op = p.op[m];
      float acc[S][4][4];
      if (m == l1) {
        // a one-layer stage starts from its boundary; otherwise A still
        // holds the input of layer l1 from the forward phase
        if (l0 == l1) load_tile<S>(A, p.kmax, stage_in, K, row0, p.N);
        __syncthreads();
        zero_acc<S>(acc);
        tile_matmul<S>(acc, A, p.kmax, p.W[m], K, D, Wc, tx, ty);  // z
        if (4 * tx < D) add_bias<S>(acc, p.b[m], tx);
      } else if (4 * tx < D) {
        // z as this thread parked it in the forward phase
        const float* src[S];
#pragma unroll
        for (int s = 0; s < S; ++s) src[s] = p.gz[m] + (size_t)s * p.N * D;
        load_rows<S>(acc, src, D, row0, p.N, tx, ty);
      }
      float asum = 0.f;
      if (4 * tx < D) {
        const float a = (op & PSCI_OP_RESIDUAL) ? __ldg(p.alpha[m]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 gv4[S];
#pragma unroll
          for (int s = 0; s < S; ++s)
            gv4[s] = *reinterpret_cast<const float4*>(G + ((size_t)s * p.kmax + 4 * tx + j) * PSCI_BM + 4 * ty);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float z[S], g[S];
#pragma unroll
            for (int s = 0; s < S; ++s) {
              z[s] = acc[s][i][j];
              g[s] = i == 0 ? gv4[s].x : i == 1 ? gv4[s].y : i == 2 ? gv4[s].z : gv4[s].w;
            }
            const int n = row0 + 4 * ty + i;
            layer_vjp_elem<S>(z, g, p, act, op, a, stage_in, first_gate, (size_t)n * D + 4 * tx + j,
                              n < p.N, asum);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
          }
        }
      }
      if (op & PSCI_OP_GATE) first_gate = false;
      if (op & PSCI_OP_RESIDUAL) {
        // d alpha of this CTA: shuffle tree in each warp, then the warps in order
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) asum += __shfl_down_sync(0xffffffffu, asum, o);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = asum;
      }
      __syncthreads();  // every thread has read its cotangents from G; red is written
      if ((op & PSCI_OP_RESIDUAL) && threadIdx.x == 0) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < PSCI_THREADS / 32; ++w) tot += red[w];
        p.apart[(size_t)blockIdx.x * p.n_res + p.aidx[m]] = tot;
      }
      if (4 * tx < D) {
        store_tile<S>(G, p.kmax, acc, tx, ty);
        float* dst[S];
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = p.gz[m] + (size_t)s * p.N * D;
        store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
      }
      __syncthreads();

      zero_acc<S>(acc);
      tile_matmul_t<S>(acc, G, p.kmax, p.W[m], K, D, Wc, kpad, tx, ty);  // gz @ W^T
      if (4 * tx < K) {
        if (m == l0 && (p.op[l1] & PSCI_OP_RESIDUAL)) {
          // the residual's share, parked in gin by this thread (K == dims[l1+1])
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int n = row0 + 4 * ty + i;
              if (n >= p.N) continue;
              const float4 r = *(reinterpret_cast<const float4*>(p.gin[s] + (size_t)n * K) + tx);
              acc[s][i][0] += r.x;
              acc[s][i][1] += r.y;
              acc[s][i][2] += r.z;
              acc[s][i][3] += r.w;
            }
        }
        if (m > 0) {
          store_tile<S>(G, p.kmax, acc, tx, ty);
        } else {
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
    l1 = l0 - 1;
  }
}

template <int S, bool ANY>
static cudaError_t launch(const GatedBwdParams& p, cudaStream_t stream) {
  const size_t smem =
      (2 * (size_t)S * p.kmax * PSCI_BM + (size_t)PSCI_KC * (p.kmax + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(jet_gated_bwd_kernel<S, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + PSCI_BM - 1) / PSCI_BM);
  jet_gated_bwd_kernel<S, ANY><<<grid, PSCI_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ANY = false: the kernel specialised to tanh (the Allen-Cahn paths'
// activation), with the code and registers of a tanh-only kernel.
template <bool ANY>
static cudaError_t launch_s(const GatedBwdParams& p, int S, cudaStream_t st) {
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
// x[S], u[S], v[S], gout[S], gin[S], gu[S], gv[S] (u, v, gu, gv may be null
// arrays when no layer is gated), W[L], b[L], alpha[L] (null entries
// without a residual), lin[L] (entry 0 unused), gz[L]; apart is device
// scratch of ceil(N / 16) * n_res floats (null when there is no residual);
// dims[L+1]; op[L]; kind/pa/pb[S]; act, act_w: the activation's id and
// parameter. kmax >= every dims[l], rounded up to a multiple of 4, and <=
// 256 (16-row tiles). A program with residuals has one width throughout.
// Returns a cudaError_t code (0 = launched).
extern "C" int jet_gated_bwd(const void* const* x, const void* const* u, const void* const* v,
                             const void* const* gout, void* const* gin, void* const* gu,
                             void* const* gv, const void* const* W, const void* const* b,
                             const void* const* alpha, void* const* lin, void* const* gz, void* apart,
                             const int* dims, const int* op, const int* kind, const int* pa,
                             const int* pb, int S, int L, int N, int kmax, int act, float act_w,
                             void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || kmax > 4 * 64 || act < 0 ||
      act >= PSCI_N_ACTS)
    return (int)cudaErrorInvalidValue;
  if (!(op[0] & PSCI_OP_STAGE)) return (int)cudaErrorInvalidValue;
  GatedBwdParams p = {};
  const bool gated = u != nullptr && v != nullptr && gu != nullptr && gv != nullptr;
  for (int s = 0; s < S; ++s) {
    p.x[s] = static_cast<const float*>(x[s]);
    p.gout[s] = static_cast<const float*>(gout[s]);
    p.gin[s] = static_cast<float*>(gin[s]);
    if (gated) {
      p.u[s] = static_cast<const float*>(u[s]);
      p.v[s] = static_cast<const float*>(v[s]);
      p.gu[s] = static_cast<float*>(gu[s]);
      p.gv[s] = static_cast<float*>(gv[s]);
    }
    p.idx.kind[s] = kind[s];
    p.idx.pa[s] = pa[s];
    p.idx.pb[s] = pb[s];
  }
  int sfirst = 0, n_res = 0;
  for (int l = 0; l < L; ++l) {
    if (op[l] & PSCI_OP_STAGE) sfirst = l;
    p.W[l] = static_cast<const float*>(W[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.alpha[l] = static_cast<const float*>(alpha[l]);
    p.lin[l] = static_cast<float*>(lin[l]);
    p.gz[l] = static_cast<float*>(gz[l]);
    p.op[l] = op[l];
    p.sfirst[l] = sfirst;
    if (l > 0 && lin[l] == nullptr) return (int)cudaErrorInvalidValue;
    if ((op[l] & PSCI_OP_GATE) && !gated) return (int)cudaErrorInvalidValue;
    if (op[l] & PSCI_OP_RESIDUAL) {
      if (alpha[l] == nullptr || apart == nullptr || dims[l + 1] != dims[0] || dims[sfirst] != dims[0])
        return (int)cudaErrorInvalidValue;
      p.aidx[l] = n_res++;
    }
  }
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.apart = static_cast<float*>(apart);
  p.act = Act{act, act_w};
  p.L = L;
  p.N = N;
  p.kmax = kmax;
  p.n_res = n_res;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(act == PSCI_TANH ? launch_s<false>(p, S, st) : launch_s<true>(p, S, st));
}

PSCI_ERROR_STRING_FN
