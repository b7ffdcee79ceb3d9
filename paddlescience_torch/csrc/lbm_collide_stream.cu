// lbm_collide_stream: one D2Q9 BGK collide + periodic stream step.
//
// Replaces paddlescience_tpu/ops/lbm.py::_lbm_kernel (pallas_call at :141).
// Per lattice cell: rho = sum_i f_i, u = sum_i e_i f_i / rho, the nine
// equilibria f_eq_i = w_i rho (1 + 3 e_i.u + 4.5 (e_i.u)^2 - 1.5 u.u), the
// BGK relaxation f_i - (f_i - f_eq_i) / tau, and the periodic shift of each
// distribution by its velocity. The shift is a push: cell (y, x) writes
// direction i to ((y + ey_i) mod H, (x + ex_i) mod W). That is a
// permutation of the cells for each i, so no two threads write one address.
// The walls and the moving lid follow in plain tensor operations
// (ops/lbm.py), as the TPU version keeps them outside its kernel.
//
// What bounds it on an H100: bytes. Each step reads and writes the lattice
// once, 2 * 9 * H * W * 4 bytes (302 MB at 2048 x 2048: 0.09 ms at
// 3.35 TB/s), for about 100 FLOPs a cell (0.4 GFLOP, 0.006 ms).
//
// Design: one thread per cell, a cell's nine values in registers; reads of
// direction i are coalesced along x, and so are the writes (a row shifted
// by at most one cell). The TPU kernel holds the whole lattice in on-chip
// memory and therefore stops near 256 x 256; this one has no such limit:
// any H, W whose product fits an int.
#include <cuda_runtime.h>

__constant__ int LBM_EX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
__constant__ int LBM_EY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
__constant__ float LBM_W[9] = {4.f / 9, 1.f / 9, 1.f / 9, 1.f / 9, 1.f / 9,
                               1.f / 36, 1.f / 36, 1.f / 36, 1.f / 36};

__global__ void __launch_bounds__(256) lbm_collide_stream_kernel(const float* __restrict__ f,
                                                                 float* __restrict__ out, int H,
                                                                 int W, float tau) {
  const int cells = H * W;
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= cells) return;
  const int y = c / W, x = c - y * W;
  float fi[9];
  float rho = 0.f, ux = 0.f, uy = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    fi[i] = __ldg(f + (size_t)i * cells + c);
    rho += fi[i];
    ux += (float)LBM_EX[i] * fi[i];
    uy += (float)LBM_EY[i] * fi[i];
  }
  ux /= rho;
  uy /= rho;
  const float usq = ux * ux + uy * uy;
  const float inv_tau = 1.f / tau;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eu = (float)LBM_EX[i] * ux + (float)LBM_EY[i] * uy;
    const float feq = LBM_W[i] * rho * (1.f + 3.f * eu + 4.5f * eu * eu - 1.5f * usq);
    const float post = fi[i] - (fi[i] - feq) * inv_tau;
    int yy = y + LBM_EY[i], xx = x + LBM_EX[i];
    yy = yy < 0 ? yy + H : (yy >= H ? yy - H : yy);
    xx = xx < 0 ? xx + W : (xx >= W ? xx - W : xx);
    out[(size_t)i * cells + (size_t)yy * W + xx] = post;
  }
}

// Host entry point: f and out are (9, H, W) float32 on the device, distinct
// buffers. Returns a cudaError_t code (0 = launched).
extern "C" int lbm_collide_stream(const void* f, void* out, int H, int W, float tau, void* stream) {
  if (H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL || f == out) return (int)cudaErrorInvalidValue;
  const int cells = H * W;
  lbm_collide_stream_kernel<<<(cells + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(out), H, W, tau);
  return (int)cudaGetLastError();
}

extern "C" const char* psci_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
