// jet_wgrad: weight and bias gradients of a jet segment, summed over the
// whole batch, deterministically.
//
// Replaces the cross-grid weight-gradient accumulation of
// paddlescience_tpu/ops/jet_pallas.py::_bwd (:526-537), where the TPU's
// sequential grid added each batch tile's dW into the same output block.
// For every layer l of the segment:
//   dW_l = sum_s y_in_s^T @ gz_s   (over all N rows and S streams)
//   db_l = sum_rows gz_0
// with y_in the layer's input jet (the segment input or a saved stage
// boundary) and gz the pre-activation cotangents from jet_mlp_bwd.
//
// Hopper's CTAs run in no order, so the sum is split-K over rows with no
// atomics: phase 1 gives each (layer, 64x64 output tile, row split) CTA its
// own partial; phase 2 adds the P partials of every element in a fixed
// order. The result is bitwise reproducible for a given shape and device.
//
// jet_alpha_reduce, at the end of this file, does the same for d alpha of
// the PirateNet residuals: jet_gated_bwd.cu leaves one partial sum per CTA
// and residual, and one block per residual adds them in a fixed order.
//
// What bounds it on an H100: operations, L*S*2*N*K*D FLOPs in float32
// (8.6 GFLOP at S=4, N=4096, L=4, K=D=256: 0.13 ms at 67 TFLOP/s); the
// reads of y_in and gz (~134 MB) take 0.04 ms at 3.35 TB/s.
#include "jet_common.cuh"

#define WG_TILE 64  // output tile edge (K rows x D columns)
#define WG_RC 32    // batch rows staged per step

struct WgradParams {
  const float* y[PSCI_MAX_L][PSCI_MAX_S];  // layer l input stream s, (N, dims[l])
  const float* gz[PSCI_MAX_L];             // (S, N, dims[l+1])
  float* dW[PSCI_MAX_L];                   // (dims[l], dims[l+1])
  float* db[PSCI_MAX_L];                   // (dims[l+1],)
  float* part;                             // [L][P][kmax * dmax + dmax]
  int dims[PSCI_MAX_L + 1];
  int L, S, N, P, rows_per, kmax, dmax;
};

__global__ void __launch_bounds__(256) jet_wgrad_partial(const WgradParams p) {
  __shared__ __align__(16) float As[WG_RC][WG_TILE];
  __shared__ __align__(16) float Bs[WG_RC][WG_TILE];
  const int l = blockIdx.z / p.P, split = blockIdx.z % p.P;
  const int K = p.dims[l], D = p.dims[l + 1];
  const int k0 = blockIdx.y * WG_TILE, c0 = blockIdx.x * WG_TILE;
  if (k0 >= K || c0 >= D) return;  // uniform over the CTA
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool bias_tile = blockIdx.y == 0;
  const int rbeg = split * p.rows_per;
  const int rend = min(p.N, rbeg + p.rows_per);

  float acc[4][4] = {};
  float dbacc[4] = {};
  for (int s = 0; s < p.S; ++s) {
    const float* ys = p.y[l][s];
    const float* gs = p.gz[l] + (size_t)s * p.N * D;
    for (int r0 = rbeg; r0 < rend; r0 += WG_RC) {
      for (int e = threadIdx.x; e < WG_RC * WG_TILE; e += 256) {
        const int rr = e / WG_TILE, cc = e % WG_TILE;
        const int r = r0 + rr;
        As[rr][cc] = (r < rend && k0 + cc < K) ? __ldg(ys + (size_t)r * K + k0 + cc) : 0.f;
        Bs[rr][cc] = (r < rend && c0 + cc < D) ? __ldg(gs + (size_t)r * D + c0 + cc) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int rr = 0; rr < WG_RC; ++rr) {
        const float4 a = *reinterpret_cast<const float4*>(&As[rr][4 * ty]);
        const float4 g = *reinterpret_cast<const float4*>(&Bs[rr][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], g.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], g.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], g.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], g.w, acc[i][3]);
        }
      }
      if (bias_tile && s == 0 && ty == 0) {
        for (int rr = 0; rr < WG_RC; ++rr)
#pragma unroll
          for (int j = 0; j < 4; ++j) dbacc[j] += Bs[rr][4 * tx + j];
      }
      __syncthreads();
    }
  }
  const size_t stride = (size_t)p.kmax * p.dmax + p.dmax;
  float* part = p.part + ((size_t)l * p.P + split) * stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < D) part[(size_t)k * p.dmax + c] = acc[i][j];
    }
  }
  if (bias_tile && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < D) part[(size_t)p.kmax * p.dmax + c] = dbacc[j];
    }
  }
}

__global__ void __launch_bounds__(256) jet_wgrad_reduce(const WgradParams p) {
  const int l = blockIdx.y;
  const int K = p.dims[l], D = p.dims[l + 1];
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  const size_t wsize = (size_t)p.kmax * p.dmax;
  const size_t stride = wsize + p.dmax;
  const float* part = p.part + (size_t)l * p.P * stride;
  float* dst = nullptr;
  if (e < wsize) {
    const int k = (int)(e / p.dmax), c = (int)(e % p.dmax);
    if (k < K && c < D) dst = p.dW[l] + (size_t)k * D + c;
  } else if (e - wsize < (size_t)D) {
    dst = p.db[l] + (e - wsize);
  }
  if (dst == nullptr) return;
  float sum = 0.f;
  for (int q = 0; q < p.P; ++q) sum += part[(size_t)q * stride + e];
  *dst = sum;
}

// Host entry point. y is a host array of L*S device pointers (layer-major),
// gz, dW, db host arrays of L device pointers; dims[L+1]; part is device
// scratch of L*P*(kmax*dmax + dmax) floats; rows_per = rows of each split.
// Returns a cudaError_t code (0 = launched).
extern "C" int jet_wgrad(const void* const* y, const void* const* gz, void* const* dW,
                         void* const* db, void* part, const int* dims, int S, int L, int N,
                         int P, int rows_per, int kmax, int dmax, void* stream) {
  if (S < 1 || S > PSCI_MAX_S || L < 1 || L > PSCI_MAX_L || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  WgradParams p = {};
  for (int l = 0; l < L; ++l) {
    for (int s = 0; s < S; ++s) p.y[l][s] = static_cast<const float*>(y[l * S + s]);
    p.gz[l] = static_cast<const float*>(gz[l]);
    p.dW[l] = static_cast<float*>(dW[l]);
    p.db[l] = static_cast<float*>(db[l]);
  }
  for (int l = 0; l <= L; ++l) p.dims[l] = dims[l];
  p.part = static_cast<float*>(part);
  p.L = L;
  p.S = S;
  p.N = N;
  p.P = P;
  p.rows_per = rows_per;
  p.kmax = kmax;
  p.dmax = dmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((dmax + WG_TILE - 1) / WG_TILE, (kmax + WG_TILE - 1) / WG_TILE, L * P);
  jet_wgrad_partial<<<grid1, 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)kmax * dmax + dmax;
  const dim3 grid2((unsigned)((total + 255) / 256), L);
  jet_wgrad_reduce<<<grid2, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// out[r] = sum_t part[t * n_res + r]: thread i adds the partials t = i,
// i + 256, ... in order, then a shared-memory tree adds the 256 sums.
__global__ void __launch_bounds__(256) jet_alpha_reduce_kernel(const float* __restrict__ part,
                                                               float* __restrict__ out, int n_tiles,
                                                               int n_res) {
  __shared__ float sums[256];
  const int r = blockIdx.x;
  float sum = 0.f;
  for (int t = threadIdx.x; t < n_tiles; t += 256) sum += part[(size_t)t * n_res + r];
  sums[threadIdx.x] = sum;
  __syncthreads();
  for (int o = 128; o > 0; o >>= 1) {
    if (threadIdx.x < o) sums[threadIdx.x] += sums[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[r] = sums[0];
}

// Host entry point: part is (n_tiles, n_res) row-major on the device, out
// (n_res,). Returns a cudaError_t code (0 = launched).
extern "C" int jet_alpha_reduce(const void* part, void* out, int n_tiles, int n_res, void* stream) {
  if (n_tiles < 1 || n_res < 1) return (int)cudaErrorInvalidValue;
  jet_alpha_reduce_kernel<<<n_res, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n_tiles, n_res);
  return (int)cudaGetLastError();
}

PSCI_ERROR_STRING_FN
