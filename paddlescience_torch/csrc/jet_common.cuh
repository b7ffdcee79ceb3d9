// Shared pieces of the jet-segment kernels (jet_mlp_fwd.cu, jet_mlp_bwd.cu,
// jet_gated_fwd.cu, jet_gated_bwd.cu, jet_wgrad.cu).
//
// Layout conventions, fixed by the Python wrappers in ops/jet_mlp.py and
// ops/jet_gated.py:
//   * a jet stream is an (N, W) row-major float32 tensor; S streams ride
//     together (stream 0 = primal, then singles, then pairs);
//   * weights are (K, D) row-major and used as x @ W (the JAX layout);
//   * a forward CTA (jet_mlp_fwd.cu, jet_gated_fwd.cu) has FW_WARPS<BM>
//     warps and keeps a tile of BM rows of all S streams row-major in
//     shared memory, Y[s][r][k] with swizzled columns (fwd_at); its product
//     runs on the tensor cores in 3xTF32 (fwd_matmul, "the forward
//     kernels' product" below): warp w owns the 16-column m-tiles w and w +
//     FW_WARPS<BM> of every stream and every row. BM = 16 (8 warps) covers
//     widths up to 256, BM = 8 (16 warps) widths up to 512; the gated
//     kernels use BM = 16 only;
//   * a backward CTA (jet_mlp_bwd.cu, jet_gated_bwd.cu) has 512 threads,
//     keeps its tiles transposed, as A[s][k][r] (k = feature, r = row in
//     the tile), and each thread owns a 4-row x 2-column micro-tile (Tile)
//     of every stream: GB_TX<BM> = 2048 / BM threads across the columns,
//     BM / 4 down the rows, so 128 x 4 threads cover 16 rows x 256 columns
//     and 256 x 2 threads 8 rows x 512 columns. Its products stage the
//     weights through a cp.async ring (ring_matmul, ring_matmul_t at the end
//     of this file);
//   * the ungated kernels take up to PSCI_MAX_S streams, the gated ones up
//     to PSCI_GATED_MAX_S. A product holds at most PSCI_GROUP_S streams of
//     accumulators in registers: above that jet_mlp_fwd.cu and
//     jet_mlp_bwd.cu run their products over two halves of the streams in
//     turn on the same shared tile (a stream's product reads only that
//     stream), and the elementwise jet rule or its VJP, which needs all S
//     streams of an element, reads them from shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PSCI_BM 16        // rows per CTA tile up to width 256
#define PSCI_BM_WIDE 8    // rows per CTA tile up to width 512
#define PSCI_THREADS 256  // threads per CTA
#define PSCI_MAX_S 16     // jet streams per segment (ungated kernels)
#define PSCI_GATED_MAX_S 8  // jet streams per segment of the gated kernels
#define PSCI_GROUP_S 8    // streams whose accumulators one product holds in registers
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

// A[s][k][r] <- src[s][(row0 + r) * K + k]; rows past N read as zero. src
// is not written during the kernel (the loads take the read-only path).
// THREADS: the CTA's threads. (jet_gated_bwd.cu)
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

// ------------------------------------------- the forward kernels' product --
//
// z_s = y_s W for every stream s of a BM-row tile, on the tensor cores:
// mma.sync m16n8k8 TF32 with float32 accumulators, taken transposed,
// z^T = W^T y^T, so that the output columns are mma's M (16), the tile's
// rows its N (8) and the layer input its K (8). Each float32 operand x is
// split into big = tf32(x) (rounded to nearest) and small = x - big (exact
// in float32; mma reads its 19 high bits), and a b ~ a_small b_big + a_big
// b_small + a_big b_big ("3xTF32"): what is dropped is below 2^-20 |a b|.
// The tensor cores align the terms of an mma to the largest and truncate,
// so a product added to a large running sum loses up to an ulp of the sum:
// accumulated over K = 512 that was 3e-5 of the result on an H100, and
// exp, whose relative error is the absolute error of its input, missed
// its limit. So each k-step's three products start from zero (the two
// small ones first) and the partial joins the running sum by a float32
// add, rounded to nearest.
//
// Fragments (g = lane >> 2, t = lane & 3; PTX ISA, mma.m16n8k8 .tf32):
// A a0 = (m g, k t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4);
// B b0 = (k t, n g), b1 = (t + 4, g); C c0 = (m g, n 2t), c1 = (g, 2t + 1),
// c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1). A k-step and an m-tile may
// number their k and m in any order, as long as A, B and C agree: here
// logical k = t, t + 4 are the physical features kb + 2t, kb + 2t + 1 and
// logical m = g, g + 8 the physical columns c0 + 2g, c0 + 2g + 1. Then
// (a0, a1), (a2, a3) and (b0, b1) are each one 8-byte shared load, and a
// thread's accumulators of an (m-tile, n-tile) are the 2 x 2 block at
// rows 8j + 2t + h (h = 0, 1) and columns c0 + 2g, c0 + 2g + 1:
// acc[h] (column c0 + 2g) and acc[2 + h] (column c0 + 2g + 1).
//
// Shared memory: the tile Y[s][r][k] at fwd_at(s, r, k) with row stride
// kst = the widest layer rounded up to 32, its columns swizzled by row
// (fwd_swz), so that the 8 rows of a B load and the 4 rows of an epilogue
// store meet 32 different banks; the weights through a ring of FW_STAGES
// chunks of PSCI_KC rows, row stride rs = fwd_ring_stride(the widest
// output) = 4 mod 16 floats, so that the 4 k-rows of an A load meet
// different banks. Chunks are copied by cp.async with rows past K and
// columns past D (to the next multiple of 16) zero-filled, and the tile's
// columns past a layer's width are zero too (fwd_load_tile, the
// epilogues): a k-step or m-tile that overhangs a layer adds exact zeros.

#define FW_STAGES 3  // weight chunks in the forward ring

// Warps of a forward CTA at tile height BM, and a warp's n-tiles (8 rows)
// and m-tiles (16 columns): 2 x 2 at BM = 16 (8 warps x 32 columns =
// 256), 1 x 2 at BM = 8 (16 warps x 32 columns = 512; with 8 warps of 4
// m-tiles, one CTA an SM, the aneurysm's product was 20% slower on an
// H100).
template <int BM>
constexpr int FW_WARPS = BM == 8 ? 16 : 8;
template <int BM>
constexpr int FW_THREADS = 32 * FW_WARPS<BM>;
template <int BM>
constexpr int FW_NT = BM / 8;
template <int BM>
constexpr int FW_MT = 256 / (BM * FW_WARPS<BM>);

// The accumulators of a warp's outputs: [m-tile][n-tile][stream][c0..c3].
template <int S, int BM>
using FwdAcc = float[FW_MT<BM>][FW_NT<BM>][S][4];

__host__ __device__ __forceinline__ int fwd_ring_stride(int dmax) { return (dmax + 15) / 16 * 16 + 4; }

// Dynamic shared memory of a forward kernel: the S-stream tile of bm rows
// and row stride kst, and the weight ring (ops/jet_mlp.py::fwd_smem
// computes the same).
__host__ __forceinline__ size_t fwd_smem(int S, int kst, int bm, int dmax) {
  return ((size_t)S * bm * kst + (size_t)FW_STAGES * PSCI_KC * fwd_ring_stride(dmax)) * sizeof(float);
}

// The column swizzle of tile row r: an XOR of bits 3-4 of the column.
__device__ __forceinline__ int fwd_swz(int r) { return ((r ^ (r >> 2)) & 3) << 3; }

// Offset of element (stream s, row r, column k) of a BM-row tile.
template <int BM>
__device__ __forceinline__ int fwd_at(int s, int r, int k, int kst) {
  return (s * BM + r) * kst + (k ^ fwd_swz(r));
}

// big = tf32(x), rounded to nearest with ties away from zero by integer
// arithmetic on the bits (cvt.rna.tf32.f32 did the same 14% slower on the
// PirateNet program on an H100), and small = x - big.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b for one warp: a 16 x 8 x 8 product of TF32 fragments.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, the same product from a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// The first layer's input into the tile: columns 0 .. K-1 of rows row0 ..
// row0+BM-1 of every stream, zero past N and from K to the next multiple
// of 8. src is not written during the kernel.
template <int S, int BM>
__device__ __forceinline__ void fwd_load_tile(float* Y, int kst, const float* const (&src)[PSCI_MAX_S], int K,
                                              int row0, int N) {
  const int K8 = (K + 7) & ~7;
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int e = threadIdx.x; e < BM * K8; e += FW_THREADS<BM>) {
      const int r = e / K8, k = e - r * K8, n = row0 + r;
      Y[fwd_at<BM>(s, r, k, kst)] = (n < N && k < K) ? __ldg(src[s] + (size_t)n * K + k) : 0.f;
    }
}

// Rows k0 .. k0+PSCI_KC-1 of W (K, D) into a ring stage [PSCI_KC][rs], by
// 16-byte cp.async (a warp copies one row at a time; the trip counts are
// those of the widest layer, 4096 / BM columns), zero past K and from D to
// the next multiple of 16. Commits one group, empty past the layer.
template <int BM>
__device__ __forceinline__ void fwd_fetch(float* dst, const float* __restrict__ W, int k0, int K, int D, int rs) {
  if (k0 < K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int pieces = (D + 15) / 16 * 4;
#pragma unroll
    for (int rr = 0; rr < PSCI_KC / FW_WARPS<BM>; ++rr) {
      const int r = warp + FW_WARPS<BM> * rr, k = k0 + r;
#pragma unroll
      for (int m = 0; m < 1024 / BM / 32; ++m) {
        const int q = lane + 32 * m;
        const bool ok = k < K && 4 * q < D;
        if (q < pieces) cp_async16(dst + r * rs + 4 * q, W + (ok ? k * D + 4 * q : 0), ok);
      }
    }
  }
  cp_async_commit();
}

// The first FW_STAGES - 1 chunks of a layer, which fwd_matmul expects in
// flight. Issue it once the ring is free: after the previous product.
template <int BM>
__device__ __forceinline__ void fwd_prologue(float* ring, const float* __restrict__ W, int K, int D, int rs) {
#pragma unroll
  for (int c = 0; c < FW_STAGES - 1; ++c) fwd_fetch<BM>(ring + c * PSCI_KC * rs, W, c * PSCI_KC, K, D, rs);
}

// acc = y W over the tile for the warp's m-tiles, K inputs, W (K, D)
// row-major with D % 4 == 0. In a narrow layer an m-tile at or past D gets
// zero weights and adds zeros (a predicate on the products would make the
// compiler fence every mma with a warp sync), and a warp with no m-tile
// below D runs no k-step (a trip count of 0, the same for the whole warp:
// MLP 5x50 at width 52 took 25% less time on an H100). Enter with the layer's
// fwd_prologue issued; the first barrier also publishes Y, written before
// the call. Ends with __syncthreads(), so Y and the ring may be
// overwritten after it.
template <int S, int BM>
__device__ __forceinline__ void fwd_matmul(FwdAcc<S, BM>& acc, const float* Y, int kst,
                                           const float* __restrict__ W, int K, int D, float* ring, int rs) {
  constexpr int MT = FW_MT<BM>, NT = FW_NT<BM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int K8 = (K + 7) & ~7, n = (K8 + PSCI_KC - 1) / PSCI_KC;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][s][q] = 0.f;
  bool live[MT];  // the warp's m-tiles that hold columns of this layer, in the ring's rows
#pragma unroll
  for (int i = 0; i < MT; ++i) live[i] = 16 * (warp + FW_WARPS<BM> * i) < D;
  int yrow[NT], ysw[NT];  // the thread's B row g of each n-tile: offset and swizzle
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    yrow[j] = (8 * j + g) * kst + 2 * t;
    ysw[j] = fwd_swz(8 * j + g);
  }
  const int wcol = 16 * warp + 2 * g + 2 * t * rs;  // A: column 2g of m-tile 0, k-row 2t
  for (int c = 0; c < n; ++c) {
    cp_async_wait<FW_STAGES - 2>();
    __syncthreads();  // chunk c has landed for every thread; chunk c-1's slot is free
    fwd_fetch<BM>(ring + ((c + FW_STAGES - 1) % FW_STAGES) * PSCI_KC * rs, W, (c + FW_STAGES - 1) * PSCI_KC, K, D,
                  rs);
    const float* Wc = ring + (c % FW_STAGES) * PSCI_KC * rs;
    const int k0 = c * PSCI_KC, steps = live[0] ? min(PSCI_KC, K8 - k0) / 8 : 0;
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float2 lo = make_float2(0.f, 0.f), hi = lo;
        if (live[i]) {
          const float* w = Wc + 8 * ks * rs + wcol + 16 * FW_WARPS<BM> * i;
          lo = *reinterpret_cast<const float2*>(w);       // k-row 2t: (a0, a1)
          hi = *reinterpret_cast<const float2*>(w + rs);  // k-row 2t + 1: (a2, a3)
        }
        tf32_split(lo.x, ab[i][0], as[i][0]);
        tf32_split(lo.y, ab[i][1], as[i][1]);
        tf32_split(hi.x, ab[i][2], as[i][2]);
        tf32_split(hi.y, ab[i][3], as[i][3]);
      }
      const int kb = k0 + 8 * ks;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 y = *reinterpret_cast<const float2*>(Y + s * BM * kst + yrow[j] + (kb ^ ysw[j]));
          tf32_split(y.x, bb[j][0], bs[j][0]);
          tf32_split(y.y, bb[j][1], bs[j][1]);
        }
        // the k-step's partial sums from zero, small products first, each
        // term over the stream's MT x NT tiles before the next, so no
        // product waits on the last; then into the running sums
        float part[MT][NT][4];
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (term == 0)
                mma_tf32_first(part[i][j], as[i], bb[j]);
              else
                mma_tf32(part[i][j], ab[i], term == 1 ? bs[j] : bb[j]);
            }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][s][q] += part[i][j][q];
      }
    }
  }
  __syncthreads();
}


// The epilogue's unit: row 8j + 2t + h of m-tile i, columns c, c + 1
// (c = 16 m + 2g), every stream. z[e][s] <- the activation's jet rule on
// the pre-activations of column c + e (the bias on the primal stream).
template <int S, int BM>
__device__ __forceinline__ void fwd_rule(float (&z)[2][S], const FwdAcc<S, BM>& acc, int i, int j, int h,
                                         const float (&bias)[2], const Act act, const JetIdx& idx) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int s = 0; s < S; ++s) z[e][s] = acc[i][j][s][2 * e + h];
    z[e][0] += bias[e];
    float f, f1, f2, f3;
    psci_act(act, z[e][0], f, f1, f2, f3);
    jet_rule_elem<S>(z[e], f, f1, f2, idx);
  }
}

// The unit's outputs into the tile as the next layer's input (unless this
// is the last layer), zero for columns past D (col_ok false), and into
// dst[s] + o (a segment output or a boundary) where there is one and the
// element exists (ok).
template <int S, int BM>
__device__ __forceinline__ void fwd_put(const float (&z)[2][S], float* Y, int kst, int r, int c, bool col_ok,
                                        bool last, float* const (&dst)[S], bool ok, size_t o) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float v[2] = {col_ok ? z[0][s] : 0.f, col_ok ? z[1][s] : 0.f};
    if (!last) st<2>(Y + fwd_at<BM>(s, r, c, kst), v);
    if (dst[s] != nullptr && ok) st<2>(dst[s] + o, v);
  }
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
