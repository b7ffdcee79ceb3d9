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
//      gate); write each layer's output, the next layer's input, to device
//      memory for jet_wgrad.cu, and park its z in the layer's gz buffer;
//   2. reverse phase, per layer from the stage's last: take z back from the
//      gz buffer (the stage's last layer computes it here, from the input
//      the forward phase left in shared memory, and parks it there too)
//      and f = act-jet(z); then,
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
// gz @ W^T once: a PirateNet group of 9 blocks (L = 27) at S=4, N=4096,
// K=D=256 does 2*27*S*2*N*K*D = 116 GFLOP in float32, 1.73 ms at 67
// TFLOP/s. Beside them, ~1.1 GB of boundary, gz and layer-input traffic,
// 0.6 GB for parking z, and the elementwise traffic of the gates and
// residuals: 18 gated layers x 6 stream sets (read u, v; read and write
// g_u, g_v) and 9 residuals x 3 (read the stage input; park and read back
// g_res), one stream set S*N*W*4 = 16.8 MB, ~2.3 GB, 0.67 ms at 3.35 TB/s
// and less where L2 serves a CTA's 16 rows.
//
// Design: as jet_mlp_bwd.cu, one CTA per 16-row tile holds the layer input
// A and the running cotangent G of all S streams in shared memory
// ([S][kmax][16] each, transposed). No atomics, a fixed summation order:
// two calls on the same inputs are bitwise equal.
//   * 512 threads, a 4-row x 2-column micro-tile of every stream each, so
//     a thread fits in 128 registers and an SM runs 16 warps. With 256
//     threads, 4 x 4 micro-tiles, 255 registers and 8 warps, the
//     elementwise part below was latency-bound on the card.
//   * Elementwise traffic in whole rows. The reverse phase walks the
//     micro-tile rows outer and columns inner: per (stream, row) a thread moves its 2 contiguous columns of u,
//     v, the residual's stage input, g_u, g_v (read before the row's
//     arithmetic, written after it; the first gate walked writes without
//     reading) and the parked g_res as one float2, so a warp's accesses
//     fill whole sectors. The cotangent micro-tile comes out of the
//     transposed G tile as float4 columns and stays in registers for the
//     layer; z comes row by row from the gz buffer where it was parked,
//     and each row's gz goes back there and over its cotangents in the
//     micro-tile, which returns to G at the end: the elementwise part
//     holds one micro-tile, not two (4-17% faster than holding z too, and
//     less spill at S >= 5, PERF.md).
//   * One tile where two do not fit (park; S >= 7 at width 256): G shares
//     A's shared memory. The stage's input cotangent goes to the gz buffer
//     of the previous stage's last layer, which reads it back into the
//     tile once its z product no longer needs A.
//   * Weight staging that overlaps the FMAs (jet_common.cuh's ring_matmul
//     and ring_matmul_t, shared with jet_mlp_bwd.cu). Both products stage
//     16-row (z = y_in @ W) or 16-column (gz @ W^T) chunks of W with 16-byte
//     cp.async copies into a ring of GB_STAGES chunks, one __syncthreads a
//     chunk: the copy of chunk c+1 is in flight while chunk c is computed.
//     The W^T chunk lands in W's own row-major layout ([k][16], no element
//     by element transposition), its four 16-byte pieces per row swizzled
//     by bits 1-2 of the row; in this product a thread owns output columns
//     tx + 128j, so the 8 lanes of each LDS.128 phase read 8 consecutive
//     rows and hit 32 distinct banks. The result goes back into G (or g_y)
//     by column index; the elementwise ownership above is unchanged.
//   cp.async rather than TMA: a segment has up to 32 weight matrices, each
//   would need its own tensor map. Widths are multiples of 4 (layer
//   outputs; the wrapper checks), so every weight row starts 16-byte
//   aligned, the narrow first input (dims[0] = 3, 5) included.
// What holds it back (PERF.md): each product runs at under half of the
// float32 FMA rate; from S = 5 a thread's 128 registers spill. A thread
// executes S + 1 shared loads per 8S FMAs (the A fragment is one float4 per
// stream); with 128 registers it cannot hold more accumulators to spread
// them over.
#include "jet_common.cuh"

// A CTA of 512 threads covers a 16-row tile (jet_common.cuh): 4 rows of
// threads (ty), each owning GB_RM = 4 tile rows, by GB_TX<16> = 128 columns
// of threads (tx), each owning GB_CN = 2 contiguous columns (widths up to
// 256).
constexpr int TX = GB_TX<PSCI_BM>;

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
  int park;  // 1: one tile for A and G, the cotangent parked between stages (bwd_smem)
};

// T[s][k][r] <- src[s][(row0 + r) * K + k], rows past N zero: load_tile
// with plain loads, for rows this kernel may have written before a
// __syncthreads().
template <int S>
__device__ __forceinline__ void gb_load_tile(float* T, int kmax, const float* const (&src)[S], int K, int row0,
                                             int N) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int e = threadIdx.x; e < PSCI_BM * K; e += GB_THREADS) {
      const int r = e / K, k = e - r * K, n = row0 + r;
      T[((size_t)s * kmax + k) * PSCI_BM + r] = (n < N) ? src[s][(size_t)n * K + k] : 0.f;
    }
}

// ------------------------------------------------ the elementwise rules --

// The activation's jet rule, then (gated) v + f (u - v) by the jet product
// rule, on the micro-tile in place; u, v rows read GB_CN floats at a time.
template <int S>
__device__ __forceinline__ void gb_act_gate(Tile<S>& acc, const GatedBwdParams& p, const Act act, bool gated, int D,
                                            int row0, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < GB_RM; ++i) {
    const int n = row0 + GB_RM * ty + i;
    float uu[S][GB_CN], vv[S][GB_CN];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      fill<GB_CN>(uu[s], 0.f);
      fill<GB_CN>(vv[s], 0.f);
      if (gated && n < p.N) {
        ldg<GB_CN>(p.u[s] + (size_t)n * D + GB_CN * tx, uu[s]);
        ldg<GB_CN>(p.v[s] + (size_t)n * D + GB_CN * tx, vv[s]);
      }
    }
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) {
      float z[S];
#pragma unroll
      for (int s = 0; s < S; ++s) z[s] = acc[s][i][j];
      float f, f1, f2, f3;
      psci_act(act, z[0], f, f1, f2, f3);
      jet_rule_elem<S>(z, f, f1, f2, p.idx);
      if (gated) {
        float ue[S], ve[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          ue[s] = uu[s][j];
          ve[s] = vv[s][j];
        }
        gate_jet_elem<S>(z, ue, ve, p.idx);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
    }
  }
}

// The reverse phase's elementwise part of layer m on the thread's
// micro-tile (GB_CN tx < D). The cotangents of the layer's output come
// from G; the layer's pre-activations z come row by row from its gz buffer
// zg (stream s at zg + s zs), where this thread parked them, and its gz
// goes back there row by row
// and into G in place of the cotangents (only the cotangent micro-tile is
// held, not z's too). Rows outer, columns inner: per (stream, row) the
// thread moves its GB_CN contiguous columns of every elementwise operand as
// one access. Residual: d alpha into asum, (1 - a) g parked in gin. Gate:
// g_u, g_v written (first_gate) or added to.
template <int S>
__device__ __forceinline__ void layer_vjp_tile(float* G, float* zg, size_t zs, const GatedBwdParams& p,
                                               const Act act, int op, float a, const float* const (&xin)[S],
                                               bool first_gate, int D, int row0, int tx, int ty, float& asum) {
  const JetIdx& idx = p.idx;
  float gt[S][GB_CN][GB_RM];  // gt[s][j][i]: cotangent (then gz) of row GB_RM ty + i, column GB_CN tx + j
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < GB_CN; ++j)
      ld<GB_RM>(G + ((size_t)s * p.kmax + GB_CN * tx + j) * PSCI_BM + GB_RM * ty, gt[s][j]);
#pragma unroll
  for (int i = 0; i < GB_RM; ++i) {
    const int n = row0 + GB_RM * ty + i;
    const bool ok = n < p.N;
    const size_t off = (size_t)n * D + GB_CN * tx;
    float zr[S][GB_CN];  // the row's z, then its gz
#pragma unroll
    for (int s = 0; s < S; ++s) {
      fill<GB_CN>(zr[s], 0.f);
      if (ok) ld<GB_CN>(zg + s * zs + off, zr[s]);  // plain loads: parked during the kernel
    }
    // the row's u - v, g_u, g_v (gate) or stage input, g_res (residual)
    float e1[S][GB_CN], e2[S][GB_CN], e3[S][GB_CN];
    if (op & PSCI_OP_RESIDUAL) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fill<GB_CN>(e1[s], 0.f);
        if (ok) ldg<GB_CN>(xin[s] + off, e1[s]);
      }
    } else if (op & PSCI_OP_GATE) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float vv[GB_CN];
        fill<GB_CN>(e1[s], 0.f);
        fill<GB_CN>(vv, 0.f);
        fill<GB_CN>(e2[s], 0.f);
        fill<GB_CN>(e3[s], 0.f);
        if (ok) {
          ldg<GB_CN>(p.u[s] + off, e1[s]);
          ldg<GB_CN>(p.v[s] + off, vv);
          if (!first_gate) {  // this thread alone owns these columns of the row
            ld<GB_CN>(p.gu[s] + off, e2[s]);
            ld<GB_CN>(p.gv[s] + off, e3[s]);
          }
        }
#pragma unroll
        for (int j = 0; j < GB_CN; ++j) e1[s][j] -= vv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) {
      float z[S], g[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        z[s] = zr[s][j];
        g[s] = gt[s][j][i];
      }
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
            asum += g[s] * (f[s] - e1[s][j]);
            e2[s][j] = (1.f - a) * g[s];
            g[s] *= a;
          }
        } else {
          float d[S], gf[S], gd[S];
#pragma unroll
          for (int s = 0; s < S; ++s) d[s] = e1[s][j];
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
#pragma unroll
          for (int s = 0; s < S; ++s) {
            e2[s][j] += gd[s];
            e3[s][j] += g[s] - gd[s];
            g[s] = gf[s];
          }
        }
      }
      jet_rule_vjp<S>(z, g, f1, f2, f3, idx);  // VJP of the activation's jet rule
#pragma unroll
      for (int s = 0; s < S; ++s) {
        zr[s][j] = z[s];
        gt[s][j][i] = z[s];
      }
    }
    if (ok) {
#pragma unroll
      for (int s = 0; s < S; ++s) st<GB_CN>(zg + s * zs + off, zr[s]);
    }
    if (ok && (op & PSCI_OP_RESIDUAL)) {
#pragma unroll
      for (int s = 0; s < S; ++s) st<GB_CN>(p.gin[s] + off, e2[s]);
    } else if (ok && (op & PSCI_OP_GATE)) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        st<GB_CN>(p.gu[s] + off, e2[s]);
        st<GB_CN>(p.gv[s] + off, e3[s]);
      }
    }
  }
  // each thread overwrites only the cotangents it read from G
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) st<GB_RM>(G + ((size_t)s * p.kmax + GB_CN * tx + j) * PSCI_BM + GB_RM * ty, gt[s][j]);
}

// ------------------------------------------------------------- kernel --

template <int S, bool ANY>
__global__ void __launch_bounds__(GB_THREADS, 1) jet_gated_bwd_kernel(const GatedBwdParams p) {
  const Act act = ANY ? p.act : Act{PSCI_TANH, 0.f};
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[GB_THREADS / 32];
  const size_t tile = (size_t)S * p.kmax * PSCI_BM;
  float* A = smem;                            // layer input y_in, [S][kmax][BM]
  float* G = p.park ? smem : smem + tile;     // running cotangent, [S][kmax][BM]
  float* ring = smem + (p.park ? 1 : 2) * tile;  // GB_STAGES weight chunks
  const int stage = PSCI_KC * p.kmax;
  const int row0 = blockIdx.x * PSCI_BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  if (!p.park) {
    const float* src[S];
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = p.gout[s];
    load_tile<S, PSCI_BM, GB_THREADS>(G, p.kmax, src, p.dims[p.L], row0, p.N);
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
      load_tile<S, PSCI_BM, GB_THREADS>(A, p.kmax, stage_in, p.dims[l0], row0, p.N);
      for (int m = l0; m < l1; ++m) {
        const int K = p.dims[m], D = p.dims[m + 1];
        Tile<S> acc;
        gb_zero<S>(acc);
        ring_matmul<S>(acc, A, p.kmax, p.W[m], K, D, ring, stage, tx, ty);
        if (GB_CN * tx < D) {
          gb_add_bias<S>(acc, p.b[m], tx);
          float* dst[S];
#pragma unroll
          for (int s = 0; s < S; ++s) dst[s] = p.gz[m] + (size_t)s * p.N * D;
          gb_store_rows<S>(dst, acc, D, row0, p.N, tx, ty);  // z, for the reverse phase
          gb_act_gate<S>(acc, p, act, p.op[m] & PSCI_OP_GATE, D, row0, tx, ty);
          gb_store_tile<S>(A, p.kmax, acc, tx, ty);
#pragma unroll
          for (int s = 0; s < S; ++s) dst[s] = p.lin[m + 1] + (size_t)s * p.N * D;
          gb_store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
        }
      }
    }

    // ---- reverse phase
    for (int m = l1; m >= l0; --m) {
      const int K = p.dims[m], D = p.dims[m + 1], op = p.op[m];
      float* const zg = p.gz[m];  // the layer's gz buffer (S, N, D): its z, parked, then its gz
      const size_t zs = (size_t)p.N * D;
      if (m == l1) {
        Tile<S> acc;
        // a one-layer stage starts from its boundary; otherwise A still
        // holds the input of layer l1 from the forward phase
        if (l0 == l1) load_tile<S, PSCI_BM, GB_THREADS>(A, p.kmax, stage_in, K, row0, p.N);
        gb_zero<S>(acc);
        ring_matmul<S>(acc, A, p.kmax, p.W[m], K, D, ring, stage, tx, ty);  // z
        if (GB_CN * tx < D) gb_add_bias<S>(acc, p.b[m], tx);
        if (p.park) {
          // the cotangent of the stage's output into the tile A held: the
          // segment's, or where the previous stage parked it (gz[l1])
          const float* src[S];
#pragma unroll
          for (int s = 0; s < S; ++s) src[s] = (m == p.L - 1) ? p.gout[s] : p.gz[m] + (size_t)s * p.N * D;
          gb_load_tile<S>(G, p.kmax, src, D, row0, p.N);
          __syncthreads();
        }
        // z parked as the forward phase parks an inner layer's (after the park's read-back of gz[l1])
        if (GB_CN * tx < D) {
          float* dst[S];
#pragma unroll
          for (int s = 0; s < S; ++s) dst[s] = zg + s * zs;
          gb_store_rows<S>(dst, acc, D, row0, p.N, tx, ty);
        }
      }
      float asum = 0.f;
      if (GB_CN * tx < D) {
        const float a = (op & PSCI_OP_RESIDUAL) ? __ldg(p.alpha[m]) : 0.f;
        layer_vjp_tile<S>(G, zg, zs, p, act, op, a, stage_in, first_gate, D, row0, tx, ty, asum);
      }
      if (op & PSCI_OP_GATE) first_gate = false;
      if (op & PSCI_OP_RESIDUAL) {
        // d alpha of this CTA: shuffle tree in each warp, then the warps in order
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) asum += __shfl_down_sync(0xffffffffu, asum, o);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = asum;
      }
      __syncthreads();  // red is written
      if ((op & PSCI_OP_RESIDUAL) && threadIdx.x == 0) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < GB_THREADS / 32; ++w) tot += red[w];
        p.apart[(size_t)blockIdx.x * p.n_res + p.aidx[m]] = tot;
      }

      Tile<S> acc;
      gb_zero<S>(acc);
      ring_matmul_t<S>(acc, G, p.kmax, p.W[m], K, D, ring, stage, tx, ty);  // gz @ W^T
      // the residual's share, parked in gin (K == dims[l1+1]) in layer l1's elementwise part
      const bool add_res = m == l0 && (p.op[l1] & PSCI_OP_RESIDUAL);
      // with park, the stage's input cotangent goes to gz[m-1], where the
      // next stage's last layer m-1 reads it back before writing its gz
      const bool park_out = p.park && m == l0 && m > 0;
#pragma unroll
      for (int j = 0; j < GB_CN; ++j) {
        const int k = tx + TX * j;
        if (k >= K) continue;
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int i = 0; i < GB_RM; ++i) {
            const int n = row0 + GB_RM * ty + i;
            if (add_res && n < p.N) acc[s][i][j] += p.gin[s][(size_t)n * K + k];
            if (m == 0 && n < p.N) p.gin[s][(size_t)n * K + k] = acc[s][i][j];
            if (park_out && n < p.N) p.gz[m - 1][((size_t)s * p.N + n) * K + k] = acc[s][i][j];
          }
          if (m > 0 && !park_out) gb_store_col<S>(G, p.kmax, acc, s, j, k, ty);
        }
      }
      __syncthreads();
    }
    l1 = l0 - 1;
  }
}

template <int S, bool ANY>
static cudaError_t launch(const GatedBwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem(S, p.kmax, PSCI_BM, p.park);
  cudaError_t err = cudaFuncSetAttribute(jet_gated_bwd_kernel<S, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + PSCI_BM - 1) / PSCI_BM);
  jet_gated_bwd_kernel<S, ANY><<<grid, GB_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

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
// dims[L+1] (dims[1..L] multiples of 4); op[L]; kind/pa/pb[S]; act, act_w:
// the activation's id and parameter. kmax >= every dims[l], rounded up to a
// multiple of 4, and <= 256 (16-row tiles). park: 1 where the two tiles and
// the ring exceed a CTA's shared memory (S >= 7 at width 256). A program
// with residuals has one width throughout. Returns a cudaError_t code (0 =
// launched).
extern "C" int jet_gated_bwd(const void* const* x, const void* const* u, const void* const* v,
                             const void* const* gout, void* const* gin, void* const* gu,
                             void* const* gv, const void* const* W, const void* const* b,
                             const void* const* alpha, void* const* lin, void* const* gz, void* apart,
                             const int* dims, const int* op, const int* kind, const int* pa,
                             const int* pb, int S, int L, int N, int kmax, int park, int act, float act_w,
                             void* stream) {
  if (S < 1 || S > PSCI_GATED_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || kmax > 4 * 64 || kmax % 4 || act < 0 ||
      act >= PSCI_N_ACTS || (park != 0 && park != 1))
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
    if (dims[l + 1] % 4 || dims[l + 1] > kmax || dims[l] > kmax) return (int)cudaErrorInvalidValue;
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
  p.park = park;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(act == PSCI_TANH ? launch_s<false>(p, S, st) : launch_s<true>(p, S, st));
}

PSCI_ERROR_STRING_FN
