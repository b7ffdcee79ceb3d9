// Shared pieces of the jet-segment kernels (jet_mlp_fwd.cu, jet_mlp_bwd.cu,
// jet_gated_fwd.cu, jet_gated_bwd.cu, jet_wgrad.cu).
//
// Layout conventions, fixed by the Python wrappers in ops/jet_mlp.py and
// ops/jet_gated.py:
//   * a jet stream is an (N, W) row-major float32 tensor; S streams ride
//     together (stream 0 = primal, then singles, then pairs);
//   * weights are (K, D) row-major and used as x @ W (the JAX layout);
//   * a row tile of PSCI_BM rows of all S streams lives in shared memory
//     transposed, as A[s][k][r] (k = feature, r = row in the tile), so a
//     thread reads the 4 rows of its micro-tile as one float4;
//   * a CTA has 256 threads: tx = tid & 63 owns output columns 4tx..4tx+3,
//     ty = tid >> 6 owns tile rows 4ty..4ty+3, for every stream.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PSCI_BM 16        // rows per CTA tile
#define PSCI_THREADS 256  // threads per CTA
#define PSCI_MAX_S 8      // jet streams per segment
#define PSCI_MAX_L 32     // layers per segment
#define PSCI_MAX_W 256    // feature width of any layer input or output
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
template <int S>
__device__ __forceinline__ void load_tile(float* A, int kmax, const float* const (&src)[S],
                                          int K, int row0, int N) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    for (int e = threadIdx.x; e < PSCI_BM * K; e += PSCI_THREADS) {
      const int r = e / K, k = e - r * K;
      const int n = row0 + r;
      const float* q = src[s] + (size_t)n * K + k;
      A[((size_t)s * kmax + k) * PSCI_BM + r] = (n < N) ? __ldg(q) : 0.f;
    }
  }
}

// acc[s][i][j] += sum_k A[s][k][4ty+i] * W[k][4tx+j], k < K; W is (K, D)
// with D % 4 == 0 and 16-byte aligned. Weight rows are staged KC at a time
// through Wc. Ends with __syncthreads(), so A may be overwritten after it.
template <int S>
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
              *reinterpret_cast<const float4*>(A + ((size_t)s * kmax + k0 + kk) * PSCI_BM + 4 * ty);
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
template <int S>
__device__ __forceinline__ void store_tile(float* A, int kmax, const float (&acc)[S][4][4],
                                           int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(A + ((size_t)s * kmax + 4 * tx + j) * PSCI_BM + 4 * ty) =
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

// Read the micro-tile rows back from S global (N, D) streams that this
// thread wrote with store_rows earlier in the kernel (plain loads, not the
// read-only path); rows past N read as zero.
template <int S>
__device__ __forceinline__ void load_rows(float (&acc)[S][4][4], const float* const (&src)[S],
                                          int D, int row0, int N, int tx, int ty) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + 4 * ty + i;
      const float4 r = n < N ? *reinterpret_cast<const float4*>(src[s] + (size_t)n * D + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[s][i][0] = r.x;
      acc[s][i][1] = r.y;
      acc[s][i][2] = r.z;
      acc[s][i][3] = r.w;
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

// acc[s][i][j] += sum_c G[s][c][4ty+i] * W[4tx+j][c], c < D: the product
// with W^T. W is (K, D); columns are staged KC at a time, transposed, into
// Wt[cc][k] with row stride kpad. Ends with __syncthreads().
template <int S>
__device__ __forceinline__ void tile_matmul_t(float (&acc)[S][4][4], const float* G, int kmax,
                                              const float* __restrict__ W, int K, int D,
                                              float* Wt, int kpad, int tx, int ty) {
  for (int c0 = 0; c0 < D; c0 += PSCI_KC) {
    const int cn = min(PSCI_KC, D - c0);
    for (int e = threadIdx.x; e < K * cn; e += PSCI_THREADS) {
      const int k = e / cn, cc = e - k * cn;
      Wt[cc * kpad + k] = __ldg(W + (size_t)k * D + c0 + cc);
    }
    __syncthreads();
    if (4 * tx < K) {
#pragma unroll 4
      for (int cc = 0; cc < cn; ++cc) {
        const float4 w = *reinterpret_cast<const float4*>(Wt + cc * kpad + 4 * tx);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a =
              *reinterpret_cast<const float4*>(G + ((size_t)s * kmax + c0 + cc) * PSCI_BM + 4 * ty);
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

// The tanh jet rule on one element's pre-activations z (all S streams):
//   y_0 = t = tanh(z_0),  y_k = sp z_k,  y_ij = spp z_i z_j + sp z_ij,
// sp = 1 - t^2, spp = -2 t sp.
template <int S>
__device__ __forceinline__ void tanh_jet_elem(float (&z)[S], const JetIdx& idx) {
  const float t = tanhf(z[0]);
  const float sp = 1.f - t * t;
  const float spp = -2.f * t * sp;
  float y[S];
  y[0] = t;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (idx.kind[s] == 1) {
      y[s] = sp * z[s];
    } else {
      y[s] = spp * sel<S>(z, idx.pa[s]) * sel<S>(z, idx.pb[s]) + sp * z[s];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = y[s];
}

template <int S>
__device__ __forceinline__ void tanh_jet(float (&acc)[S][4][4], const JetIdx& idx, int i, int j) {
  float z[S];
#pragma unroll
  for (int s = 0; s < S; ++s) z[s] = acc[s][i][j];
  tanh_jet_elem<S>(z, idx);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s][i][j] = z[s];
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

#define PSCI_ERROR_STRING_FN                                   \
  extern "C" const char* psci_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
