// Shared pieces of the jet-segment kernels (jet_mlp_fwd.cu, jet_mlp_bwd.cu,
// jet_gated_fwd.cu, jet_gated_bwd.cu, jet_wgrad.cu).
//
// Layout conventions, fixed by the Python wrappers in ops/jet_mlp.py and
// ops/jet_gated.py:
//   * a jet stream is an (N, W) row-major float32 tensor; S streams ride
//     together (stream 0 = primal, then singles, then pairs);
//   * weights are (K, D) row-major and used as x @ W (the JAX layout);
//   * a row tile of BM rows of all S streams lives in shared memory
//     transposed, as A[s][k][r] (k = feature, r = row in the tile), so a
//     thread reads the 4 rows of its micro-tile as one float4;
//   * a forward CTA (jet_mlp_fwd.cu, jet_gated_fwd.cu) has 256 threads,
//     TX = 1024 / BM across the columns and BM / 4 down the rows: tx = tid
//     % TX owns output columns 4tx..4tx+3, ty = tid / TX owns tile rows
//     4ty..4ty+3, for every stream. BM = 16 (64 x 4 threads) covers widths
//     up to 256, BM = 8 (128 x 2) widths up to 512; the gated kernels use
//     BM = 16 only;
//   * a backward CTA (jet_mlp_bwd.cu, jet_gated_bwd.cu) has 512 threads,
//     each owning a 4-row x 2-column micro-tile (Tile) of every stream:
//     GB_TX<BM> = 2048 / BM threads across the columns, BM / 4 down the
//     rows, so 128 x 4 threads cover 16 rows x 256 columns and 256 x 2
//     threads 8 rows x 512 columns. Its products stage the weights through
//     a cp.async ring (ring_matmul, ring_matmul_t at the end of this file).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PSCI_BM 16        // rows per CTA tile up to width 256
#define PSCI_BM_WIDE 8    // rows per CTA tile up to width 512
#define PSCI_THREADS 256  // threads per CTA
#define PSCI_MAX_S 8      // jet streams per segment
#define PSCI_MAX_L 32     // layers per segment
#define PSCI_KC 16        // weight rows (or columns) staged per chunk

// Op-code bits of a layer in a gated layer program (ops/jet_gated.py).
#define PSCI_OP_GATE 1      // v + y * (u - v) after the activation
#define PSCI_OP_RESIDUAL 2  // alpha * y + (1 - alpha) * (the stage's input)
#define PSCI_OP_STAGE 4     // the layer starts a stage

// Which stream is what: kind 0 = primal, 1 = single (first derivative),
// 2 = pair (second derivative) whose singles sit at stream positions pa, pb.
struct JetIdx {
  int kind[PSCI_MAX_S];
  int pa[PSCI_MAX_S];
  int pb[PSCI_MAX_S];
};

// Activation ids, the same as paddlescience_torch/autodiff/jet.py (ACT_RULES).
enum PsciActId {
  PSCI_TANH = 0, PSCI_IDENTITY, PSCI_SIN, PSCI_COS, PSCI_EXP, PSCI_SIGMOID, PSCI_SILU, PSCI_SOFTPLUS,
  PSCI_MISH, PSCI_GELU, PSCI_RELU, PSCI_RELU6, PSCI_ELU, PSCI_SELU, PSCI_LEAKY_RELU, PSCI_SIREN,
  PSCI_N_ACTS
};

// The activation of a segment: its id and one parameter (Siren's w0).
struct Act {
  int id;
  float w;
};

__device__ __forceinline__ void sigmoid4(float x, float& s, float& s1, float& s2, float& s3) {
  s = 1.f / (1.f + expf(-x));
  s1 = s * (1.f - s);
  s2 = s1 * (1.f - 2.f * s);
  s3 = s1 * (1.f - 6.f * s + 6.f * s * s);
}

// f, f1 = f', f2 = f'', f3 = f''' of activation a at x: the closed forms of
// autodiff/jet.py::ACT_RULES, term for term (at a kink, the derivative
// JAX's jvp of jax.nn takes). The id is the same for the whole grid, so the
// switch never diverges; outputs a caller does not use fold away.
__device__ __forceinline__ void psci_act(const Act a, float x, float& f, float& f1, float& f2, float& f3) {
  switch (a.id) {
    case PSCI_IDENTITY:
      f = x;
      f1 = 1.f;
      f2 = f3 = 0.f;
      break;
    case PSCI_SIN: {
      float s, c;
      sincosf(x, &s, &c);
      f = s;
      f1 = c;
      f2 = -s;
      f3 = -c;
      break;
    }
    case PSCI_COS: {
      float s, c;
      sincosf(x, &s, &c);
      f = c;
      f1 = -s;
      f2 = -c;
      f3 = s;
      break;
    }
    case PSCI_EXP:
      f = f1 = f2 = f3 = expf(x);
      break;
    case PSCI_SIGMOID:
      sigmoid4(x, f, f1, f2, f3);
      break;
    case PSCI_SILU: {
      float s, s1, s2, s3;
      sigmoid4(x, s, s1, s2, s3);
      f = x * s;
      f1 = s + x * s1;
      f2 = 2.f * s1 + x * s2;
      f3 = 3.f * s2 + x * s3;
      break;
    }
    case PSCI_SOFTPLUS: {
      float s3;
      sigmoid4(x, f1, f2, f3, s3);
      f = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // logaddexp(x, 0)
      break;
    }
    case PSCI_MISH: {  // x tanh(softplus x)
      float s, s1, s2, s3;
      sigmoid4(x, s, s1, s2, s3);
      const float g = tanhf(fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))));
      const float h = 1.f - g * g;
      const float g1 = h * s;
      const float h1 = -2.f * g * g1;
      const float g2 = h1 * s + h * s1;
      const float h2 = -2.f * (g1 * g1 + g * g2);
      const float g3 = h2 * s + 2.f * h1 * s1 + h * s2;
      f = x * g;
      f1 = g + x * g1;
      f2 = 2.f * g1 + x * g2;
      f3 = 3.f * g2 + x * g3;
      break;
    }
    case PSCI_GELU: {  // the tanh approximation
      const float k = 0.7978845608028654f, c = 0.044715f;
      const float u1 = k * (1.f + 3.f * c * x * x);
      const float u2 = 6.f * k * c * x;
      const float t = tanhf(k * (x + c * x * x * x));
      const float s = 1.f - t * t;
      const float t1 = s * u1;
      const float t2 = -2.f * t * t1 * u1 + s * u2;
      const float t3 = -2.f * (t1 * t1 * u1 + t * t2 * u1 + 2.f * t * t1 * u2) + s * (6.f * k * c);
      f = 0.5f * x * (1.f + t);
      f1 = 0.5f * (1.f + t) + 0.5f * x * t1;
      f2 = t1 + 0.5f * x * t2;
      f3 = 1.5f * t2 + 0.5f * x * t3;
      break;
    }
    case PSCI_RELU:
      f = x > 0.f ? x : 0.f;
      f1 = x > 0.f ? 1.f : 0.f;
      f2 = f3 = 0.f;
      break;
    case PSCI_RELU6:
      f = fminf(fmaxf(x, 0.f), 6.f);
      f1 = (x > 0.f && x < 6.f) ? 1.f : 0.f;
      f2 = f3 = 0.f;
      break;
    case PSCI_ELU:
    case PSCI_SELU: {
      const float alpha = a.id == PSCI_ELU ? 1.f : 1.6732632423543772848170429916717f;
      const float scale = a.id == PSCI_ELU ? 1.f : 1.0507009873554804934193349852946f;
      if (x > 0.f) {
        f = scale * x;
        f1 = scale;
        f2 = f3 = 0.f;
      } else {
        f = (scale * alpha) * expm1f(x);
        f1 = f2 = f3 = (scale * alpha) * expf(x);
      }
      break;
    }
    case PSCI_LEAKY_RELU:
      f = x >= 0.f ? x : 0.01f * x;
      f1 = x >= 0.f ? 1.f : 0.01f;
      f2 = f3 = 0.f;
      break;
    case PSCI_SIREN: {  // sin(w0 x)
      float s, c;
      sincosf(a.w * x, &s, &c);
      f = s;
      f1 = a.w * c;
      f2 = -a.w * a.w * s;
      f3 = -a.w * a.w * a.w * c;
      break;
    }
    default: {  // PSCI_TANH
      const float t = tanhf(x);
      const float sp = 1.f - t * t;
      f = t;
      f1 = sp;
      f2 = -2.f * t * sp;
      f3 = -2.f * sp * sp + 4.f * t * t * sp;
      break;
    }
  }
}

// z[a] for a runtime a, without dynamic register indexing.
template <int S>
__device__ __forceinline__ float sel(const float (&z)[S], int a) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < S; ++q) v = (q == a) ? z[q] : v;
  return v;
}

template <int S>
__device__ __forceinline__ void add_at(float (&g)[S], int a, float v) {
#pragma unroll
  for (int q = 0; q < S; ++q)
    if (q == a) g[q] += v;
}

template <int S>
__device__ __forceinline__ void zero_acc(float (&acc)[S][4][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;
}

// A[s][k][r] <- src[s][(row0 + r) * K + k]; rows past N read as zero. src
// is not written during the kernel (the loads take the read-only path).
// THREADS: the CTA's threads.
template <int S, int BM = PSCI_BM, int THREADS = PSCI_THREADS>
__device__ __forceinline__ void load_tile(float* A, int kmax, const float* const (&src)[S],
                                          int K, int row0, int N) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    for (int e = threadIdx.x; e < BM * K; e += THREADS) {
      const int r = e / K, k = e - r * K;
      const int n = row0 + r;
      const float* q = src[s] + (size_t)n * K + k;
      A[((size_t)s * kmax + k) * BM + r] = (n < N) ? __ldg(q) : 0.f;
    }
  }
}

// acc[s][i][j] += sum_k A[s][k][4ty+i] * W[k][4tx+j], k < K; W is (K, D)
// with D % 4 == 0 and 16-byte aligned. Weight rows are staged KC at a time
// through Wc. Ends with __syncthreads(), so A may be overwritten after it.
template <int S, int BM = PSCI_BM>
__device__ __forceinline__ void tile_matmul(float (&acc)[S][4][4], const float* A, int kmax,
                                            const float* __restrict__ W, int K, int D,
                                            float* Wc, int tx, int ty) {
  for (int k0 = 0; k0 < K; k0 += PSCI_KC) {
    const int kc = min(PSCI_KC, K - k0);
    const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * D);
    float4* dst = reinterpret_cast<float4*>(Wc);
    for (int e = threadIdx.x; e < kc * D / 4; e += PSCI_THREADS) dst[e] = __ldg(src + e);
    __syncthreads();
    if (4 * tx < D) {
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(Wc + kk * D + 4 * tx);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a =
              *reinterpret_cast<const float4*>(A + ((size_t)s * kmax + k0 + kk) * BM + 4 * ty);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[s][i][0] = fmaf(av[i], w.x, acc[s][i][0]);
            acc[s][i][1] = fmaf(av[i], w.y, acc[s][i][1]);
            acc[s][i][2] = fmaf(av[i], w.z, acc[s][i][2]);
            acc[s][i][3] = fmaf(av[i], w.w, acc[s][i][3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Write the thread's micro-tile back into a tile A[s][c][r] (c = 4tx+j).
template <int S, int BM = PSCI_BM>
__device__ __forceinline__ void store_tile(float* A, int kmax, const float (&acc)[S][4][4],
                                           int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(A + ((size_t)s * kmax + 4 * tx + j) * BM + 4 * ty) =
          make_float4(acc[s][0][j], acc[s][1][j], acc[s][2][j], acc[s][3][j]);
}

// Store the micro-tile rows to S global (N, D) streams dst[s]; D % 4 == 0.
template <int S>
__device__ __forceinline__ void store_rows(float* const (&dst)[S], const float (&acc)[S][4][4],
                                           int D, int row0, int N, int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + 4 * ty + i;
      if (n < N)
        *reinterpret_cast<float4*>(dst[s] + (size_t)n * D + 4 * tx) =
            make_float4(acc[s][i][0], acc[s][i][1], acc[s][i][2], acc[s][i][3]);
    }
}

// Add the bias to the primal stream's pre-activations.
template <int S>
__device__ __forceinline__ void add_bias(float (&acc)[S][4][4], const float* __restrict__ b, int tx) {
  const float4 bias = __ldg(reinterpret_cast<const float4*>(b) + tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[0][i][0] += bias.x;
    acc[0][i][1] += bias.y;
    acc[0][i][2] += bias.z;
    acc[0][i][3] += bias.w;
  }
}

// The jet rule on one element's pre-activations z (all S streams), with
// f, f1 = f', f2 = f'' of the activation at z_0:
//   y_0 = f,  y_k = f1 z_k,  y_ij = f2 z_i z_j + f1 z_ij.
template <int S>
__device__ __forceinline__ void jet_rule_elem(float (&z)[S], float f, float f1, float f2, const JetIdx& idx) {
  float y[S];
  y[0] = f;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (idx.kind[s] == 1) {
      y[s] = f1 * z[s];
    } else {
      y[s] = f2 * sel<S>(z, idx.pa[s]) * sel<S>(z, idx.pb[s]) + f1 * z[s];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = y[s];
}

// The activation's jet rule on element (i, j) of the thread's micro-tile.
template <int S>
__device__ __forceinline__ void act_jet(float (&acc)[S][4][4], const JetIdx& idx, const Act act, int i, int j) {
  float z[S];
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = acc[s][i][j];
  float f, f1, f2, f3;
  psci_act(act, z[0], f, f1, f2, f3);
  jet_rule_elem<S>(z, f, f1, f2, idx);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
}

// VJP of the jet rule: z holds the pre-activations on entry and their
// cotangents on exit, g the cotangents of the rule's outputs, f1, f2, f3
// the activation's derivatives at z_0:
//   gz_0  = f1 g_0 + f2 sum_k g_k z_k + sum_ij (f3 z_i z_j + f2 z_ij) g_ij
//   gz_k  = f1 g_k + sum_{pairs ij containing k} f2 g_ij z_other
//           (the pair (k,k) contributes 2 f2 g_kk z_k)
//   gz_ij = f1 g_ij.
template <int S>
__device__ __forceinline__ void jet_rule_vjp(float (&z)[S], const float (&g)[S], float f1, float f2, float f3,
                                             const JetIdx& idx) {
  float gz[S];
  gz[0] = f1 * g[0];
#pragma unroll
  for (int s = 1; s < S; ++s) {
    gz[s] = f1 * g[s];
    if (idx.kind[s] == 1) {
      gz[0] += f2 * g[s] * z[s];
    } else {
      const float za = sel<S>(z, idx.pa[s]), zb = sel<S>(z, idx.pb[s]);
      gz[0] += (f3 * za * zb + f2 * z[s]) * g[s];
      add_at<S>(gz, idx.pa[s], f2 * g[s] * zb);
      add_at<S>(gz, idx.pb[s], f2 * g[s] * za);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = gz[s];
}

// The gate v + f * (u - v) on one element, by the jet product rule with
// d = u - v:  o_0 = v_0 + f_0 d_0,  o_k = v_k + f_k d_0 + f_0 d_k,
//   o_ij = v_ij + f_ij d_0 + f_0 d_ij + f_i d_j + f_j d_i.
template <int S>
__device__ __forceinline__ void gate_jet_elem(float (&f)[S], const float (&u)[S], const float (&v)[S],
                                              const JetIdx& idx) {
  float d[S], o[S];
#pragma unroll
  for (int s = 0; s < S; ++s) d[s] = u[s] - v[s];
  o[0] = v[0] + f[0] * d[0];
#pragma unroll
  for (int s = 1; s < S; ++s) {
    o[s] = v[s] + f[s] * d[0] + f[0] * d[s];
    if (idx.kind[s] == 2)
      o[s] += sel<S>(f, idx.pa[s]) * sel<S>(d, idx.pb[s]) + sel<S>(f, idx.pb[s]) * sel<S>(d, idx.pa[s]);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) f[s] = o[s];
}

// Gate the thread's micro-tile in place; u[s], v[s] are (N, D) in device
// memory, read once per element by the thread that owns it. Rows past N
// take u = v = 0.
template <int S>
__device__ __forceinline__ void gate_tile(float (&acc)[S][4][4], const float* const (&u)[S],
                                          const float* const (&v)[S], int D, int row0, int N,
                                          const JetIdx& idx, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + 4 * ty + i;
    float4 uu[S], vv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      uu[s] = vv[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) {
        uu[s] = __ldg(reinterpret_cast<const float4*>(u[s] + (size_t)n * D) + tx);
        vv[s] = __ldg(reinterpret_cast<const float4*>(v[s] + (size_t)n * D) + tx);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[S], ue[S], ve[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        f[s] = acc[s][i][j];
        ue[s] = j == 0 ? uu[s].x : j == 1 ? uu[s].y : j == 2 ? uu[s].z : uu[s].w;
        ve[s] = j == 0 ? vv[s].x : j == 1 ? vv[s].y : j == 2 ? vv[s].z : vv[s].w;
      }
      gate_jet_elem<S>(f, ue, ve, idx);
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s][i][j] = f[s];
    }
  }
}

// Asynchronous copies from device to shared memory (cp.async): 16 bytes
// through L2 only, or 4; ok = false writes zeros (source size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------- the backward kernels' 512-thread tiles --

#define GB_THREADS 512  // threads of a backward CTA
#define GB_RM 4         // rows of a thread's micro-tile
#define GB_CN 2         // columns of a thread's micro-tile
#define GB_STAGES 2     // weight chunks in the cp.async ring

// Column threads of a BM-row tile: 128 at BM = 16, 256 at BM = 8.
template <int BM>
constexpr int GB_TX = GB_THREADS * GB_RM / BM;

// A thread's micro-tile of one stream: rows GB_RM ty + i, columns GB_CN tx + j
// (from ring_matmul_t: columns tx + GB_TX j).
template <int S>
using Tile = float[S][GB_RM][GB_CN];

// N (2 or 4) contiguous floats as one access.
template <int N>
__device__ __forceinline__ void ld(const float* p, float (&v)[N]) {
  static_assert(N == 2 || N == 4, "float2 or float4");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

// The same through the read-only path (data the kernel does not write).
template <int N>
__device__ __forceinline__ void ldg(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void st(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int N>
__device__ __forceinline__ void fill(float (&v)[N], float x) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = x;
}

// Column j of the micro-tile into a transposed tile A[s][c][r] at column c.
template <int S, int BM = PSCI_BM>
__device__ __forceinline__ void gb_store_col(float* A, int kmax, const Tile<S>& acc, int s, int j, int c, int ty) {
  float v[GB_RM];
#pragma unroll
  for (int i = 0; i < GB_RM; ++i) v[i] = acc[s][i][j];
  st<GB_RM>(A + ((size_t)s * kmax + c) * BM + GB_RM * ty, v);
}

// The micro-tile into a transposed tile A[s][c][r] (c = GB_CN tx + j).
template <int S, int BM = PSCI_BM>
__device__ __forceinline__ void gb_store_tile(float* A, int kmax, const Tile<S>& acc, int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) gb_store_col<S, BM>(A, kmax, acc, s, j, GB_CN * tx + j, ty);
}

// The micro-tile rows to S (N, D) streams in device memory.
template <int S>
__device__ __forceinline__ void gb_store_rows(float* const (&dst)[S], const Tile<S>& acc, int D, int row0, int N,
                                              int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < GB_RM; ++i) {
      const int n = row0 + GB_RM * ty + i;
      if (n < N) st<GB_CN>(dst[s] + (size_t)n * D + GB_CN * tx, acc[s][i]);
    }
}

template <int S>
__device__ __forceinline__ void gb_zero(Tile<S>& acc) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < GB_RM; ++i) fill<GB_CN>(acc[s][i], 0.f);
}

// The bias on the primal stream's pre-activations.
template <int S>
__device__ __forceinline__ void gb_add_bias(Tile<S>& acc, const float* __restrict__ b, int tx) {
  float bias[GB_CN];
  ldg<GB_CN>(b + GB_CN * tx, bias);
#pragma unroll
  for (int i = 0; i < GB_RM; ++i)
#pragma unroll
    for (int j = 0; j < GB_CN; ++j) acc[0][i][j] += bias[j];
}

// ------------------------------------------------ ring-staged products --

// load_tile through cp.async, for a backward CTA: 4-byte copies into the
// transposed tile, rows past N zero-filled, all in flight at once and
// committed as one group, which the next ring product's first wait takes
// in (no thread waits on a load in between).
template <int S, int BM>
__device__ __forceinline__ void stage_tile(float* A, int kmax, const float* const (&src)[S], int K, int row0,
                                           int N) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int e = threadIdx.x; e < BM * K; e += GB_THREADS) {
      const int r = e / K, k = e - r * K, n = row0 + r;
      cp_async4(A + ((size_t)s * kmax + k) * BM + r, n < N ? src[s] + (size_t)n * K + k : src[s], n < N);
    }
  cp_async_commit();
}

// Rows k0 .. k0+kc-1 of W (K, D): one contiguous block of kc * D floats.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ W, int k0, int kc, int D) {
  const float* src = W + (size_t)k0 * D;
  for (int e = threadIdx.x; e < kc * D / 4; e += GB_THREADS) cp_async16(dst + 4 * e, src + 4 * e, true);
}

// Columns c0 .. c0+cn-1 (cn <= 16, a multiple of 4) of every row of W
// (K, D), row-major as dst[k][16]; the 16-byte piece p of row k sits at
// piece p ^ ((k >> 1) & 3). Pieces past cn are zero.
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ W, int c0, int cn, int K, int D) {
  for (int e = threadIdx.x; e < 4 * K; e += GB_THREADS) {
    const int k = e >> 2, p = e & 3;
    const bool ok = 4 * p < cn;
    cp_async16(dst + k * PSCI_KC + 4 * (p ^ ((k >> 1) & 3)), ok ? W + (size_t)k * D + c0 + 4 * p : W, ok);
  }
}

// acc[s][i][j] += sum_k A[s][k][GB_RM ty + i] * W[k][GB_CN tx + j], k < K;
// A a transposed BM-row tile, W (K, D), D % 4 == 0. Chunks of 16 weight
// rows go through the ring (stage floats each). Enter with the ring free;
// the first barrier also publishes A, written before the call. Ends with
// __syncthreads(), so A and the ring may be overwritten after it.
template <int S, int BM = PSCI_BM>
__device__ __forceinline__ void ring_matmul(Tile<S>& acc, const float* A, int kmax, const float* __restrict__ W,
                                            int K, int D, float* ring, int stage, int tx, int ty) {
  const int n = (K + PSCI_KC - 1) / PSCI_KC;
  auto fetch = [&](int c) {
    if (c < n) stage_rows(ring + (c % GB_STAGES) * stage, W, c * PSCI_KC, min(PSCI_KC, K - c * PSCI_KC), D);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < GB_STAGES - 1; ++c) fetch(c);
  for (int c = 0; c < n; ++c) {
    cp_async_wait<GB_STAGES - 2>();
    __syncthreads();  // chunk c has landed for every thread; chunk c-1's slot is free
    fetch(c + GB_STAGES - 1);
    const float* Wc = ring + (c % GB_STAGES) * stage;
    const int k0 = c * PSCI_KC, kc = min(PSCI_KC, K - k0);
    if (GB_CN * tx < D) {
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float w[GB_CN];
        ld<GB_CN>(Wc + kk * D + GB_CN * tx, w);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float a[GB_RM];
          ld<GB_RM>(A + ((size_t)s * kmax + k0 + kk) * BM + GB_RM * ty, a);
#pragma unroll
          for (int i = 0; i < GB_RM; ++i)
#pragma unroll
            for (int j = 0; j < GB_CN; ++j) acc[s][i][j] = fmaf(a[i], w[j], acc[s][i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// acc[s][i][j] += sum_c G[s][c][GB_RM ty + i] * W[tx + TX j][c], c < D
// (TX = GB_TX<BM>): the product with W^T, output column tx + TX j (rows
// past K read row K-1; their sums are not used). With SKIP a thread with
// no column below K skips the FMAs: a narrow K, such as a first layer's 3
// inputs, then costs no full product; jet_gated_bwd.cu leaves it off, as
// it changes that kernel's registers. Chunks of 16 columns of W go through
// the ring as stage_cols lays them out: the 8 lanes of an LDS.128 phase
// read 8 consecutive rows, whose swizzled pieces cover the 32 banks. Enter
// with the ring free; the first barrier also publishes G, written before
// the call. Ends with __syncthreads(), so G and the ring may be
// overwritten after it.
template <int S, int BM = PSCI_BM, bool SKIP = false>
__device__ __forceinline__ void ring_matmul_t(Tile<S>& acc, const float* G, int kmax, const float* __restrict__ W,
                                              int K, int D, float* ring, int stage, int tx, int ty) {
  constexpr int TX = GB_TX<BM>;
  const int n = (D + PSCI_KC - 1) / PSCI_KC;
  const int sw = (tx >> 1) & 3;  // the swizzle of rows tx + TX j
  int wrow[GB_CN];
#pragma unroll
  for (int j = 0; j < GB_CN; ++j) wrow[j] = min(tx + TX * j, K - 1) * PSCI_KC;
  auto fetch = [&](int c) {
    if (c < n) stage_cols(ring + (c % GB_STAGES) * stage, W, c * PSCI_KC, min(PSCI_KC, D - c * PSCI_KC), K, D);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < GB_STAGES - 1; ++c) fetch(c);
  for (int c = 0; c < n; ++c) {
    cp_async_wait<GB_STAGES - 2>();
    __syncthreads();
    fetch(c + GB_STAGES - 1);
    const float* Wt = ring + (c % GB_STAGES) * stage;
    const int c0 = c * PSCI_KC, cn = min(PSCI_KC, D - c0);
    if (!SKIP || tx < K) {
#pragma unroll 1
      for (int q4 = 0; q4 < cn / 4; ++q4) {
        float w[GB_CN][4];
#pragma unroll
        for (int j = 0; j < GB_CN; ++j) ld<4>(Wt + wrow[j] + 4 * (q4 ^ sw), w[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float a[GB_RM];
            ld<GB_RM>(G + ((size_t)s * kmax + c0 + 4 * q4 + q) * BM + GB_RM * ty, a);
#pragma unroll
            for (int i = 0; i < GB_RM; ++i)
#pragma unroll
              for (int j = 0; j < GB_CN; ++j) acc[s][i][j] = fmaf(a[i], w[j][q], acc[s][i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Dynamic shared memory of a backward kernel: the layer-input and
// cotangent tiles of BM rows (one shared tile with park) and the weight
// ring (ops/jet_mlp.py::bwd_smem computes the same).
__host__ __forceinline__ size_t bwd_smem(int S, int kmax, int bm, int park) {
  return ((park ? 1 : 2) * (size_t)S * kmax * bm + (size_t)GB_STAGES * PSCI_KC * kmax) * sizeof(float);
}

#define PSCI_ERROR_STRING_FN                                   \
  extern "C" const char* psci_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
