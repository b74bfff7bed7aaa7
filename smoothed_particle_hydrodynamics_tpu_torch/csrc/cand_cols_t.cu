// The force sweep's candidate columns as one pass over the candidates, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_t.py, whose
// fused_cand_cols_plain is the PyTorch version of the same columns.
//
// Replaces no TPU kernel.  The JAX package's fused_cand_cols
// (ops/pallas_step_t.py) is plain jnp, which XLA fuses into one pass; run
// eagerly in PyTorch the same columns are about eleven elementwise launches
// over [M] and [M, 3] (safe_inv's guard and reciprocal, the pressure, rimj,
// m * pwj, rimj * v) and a cat of six pieces into [M, 9], each reading and
// writing device memory once; in capped mode three more gathers through
// sub_perm come first.
//
// What it computes, for each candidate row s, with j = idx[s] (indexed) or
// j = s, in the twin's order of operations:
//   inv = 1 / (rho_j > 0 ? rho_j : 1)    (a NaN density takes the 1)
//   p   = (rho_j - rho0) * k             (the raw density)
//   rimj = inv * m_s
//   out[s] = x_j, y_j, z_j, rimj * v_j (3), rimj, m_s, m_s * ((p * inv) * inv)
// The mass is taken at s, not at j: the capped caller passes the sub frame's
// reweighted masses, already in candidate order.  Each product, difference
// and reciprocal rounds once (__f*_rn; the library is built with
// --fmad=false besides), and 1/x is the IEEE reciprocal, as the twin's
// reciprocal() * 1.0 is on the card, so the columns equal the twin's bit
// for bit.
//
// What bounds it: bytes.  A row reads x, v, rho and m (32 B; capped, the
// sectors sub_perm touches and its 4 B index) and writes 36 B, with no
// reuse: 68 B a row, 0.203 ms at 10M rows at 3.35 TB/s.  The design: a
// persistent grid of a few blocks an SM walks tiles of kTile rows; a warp's
// loads of 32 consecutive [., 3] rows fill whole cache lines (the y and z
// words served from L1 after the x load), through any row stride whose last
// stride is 1, so a slab frame's column views are read in place; each tile's
// [kTile, 9] block is staged in shared memory (a thread's 9 words at stride
// 9, coprime to the 32 banks) and written back as aligned float4 stores
// (kTile * 36 B is a multiple of 16), the last, partial tile word by word.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 256;   // rows a tile = threads a block
constexpr int kCols = 9;
constexpr int kTileWords = kTile * kCols;
constexpr int kTileVec4 = kTileWords / 4;
static_assert(kTileWords % 4 == 0, "a tile's block is whole float4s");

struct Args {
  const float* pos;   // [R, 3] rows at pos_stride floats
  const float* vel;   // [R, 3] rows at vel_stride floats
  const float* rho;   // [R] at rho_stride floats
  const float* mass;  // [M] at mass_stride floats
  const int* idx;     // [M] rows of pos, vel, rho (indexed instance only)
  float* out;         // [M, 9], 16-byte aligned
  long long pos_stride;
  long long vel_stride;
  long long rho_stride;
  long long mass_stride;
  int m;
  float rho0;
  float stiffness;
};

template <bool kIndexed>
__global__ void __launch_bounds__(kTile, 8) cand_cols_t(Args a) {
  __shared__ __align__(16) float tile[kTileWords];
  const int tiles = (a.m + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int s0 = t * kTile;
    const int rows = min(kTile, a.m - s0);
    const int s = s0 + threadIdx.x;
    if (threadIdx.x < rows) {
      const long long j = kIndexed ? static_cast<long long>(__ldg(a.idx + s))
                                   : static_cast<long long>(s);
      const float* xp = a.pos + j * a.pos_stride;
      const float* vp = a.vel + j * a.vel_stride;
      const float rho = __ldg(a.rho + j * a.rho_stride);
      const float m =
          __ldg(a.mass + static_cast<long long>(s) * a.mass_stride);
      const float inv = __frcp_rn(rho > 0.0f ? rho : 1.0f);
      const float p = __fmul_rn(__fsub_rn(rho, a.rho0), a.stiffness);
      const float rimj = __fmul_rn(inv, m);
      float* row = tile + threadIdx.x * kCols;
      for (int k = 0; k < 3; ++k) {
        row[k] = __ldg(xp + k);
        row[3 + k] = __fmul_rn(rimj, __ldg(vp + k));
      }
      row[6] = rimj;
      row[7] = m;
      row[8] = __fmul_rn(m, __fmul_rn(__fmul_rn(p, inv), inv));
    }
    __syncthreads();
    float* dst = a.out + static_cast<long long>(s0) * kCols;
    if (rows == kTile) {
      const float4* src4 = reinterpret_cast<const float4*>(tile);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int w = threadIdx.x; w < kTileVec4; w += kTile) dst4[w] = src4[w];
    } else {
      for (int w = threadIdx.x; w < rows * kCols; w += kTile) dst[w] = tile[w];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the pass over m > 0 candidate rows on `stream` (a cudaStream_t)
// in nblocks blocks and returns cudaGetLastError(): nonzero when the launch
// was refused or an argument is not one it takes (out not 16-byte aligned).
// idx null: row s reads row s; else row s reads row idx[s] of pos, vel and
// rho (each idx[s] must be a row of them) and its own mass.  Strides are in
// floats.
int sph_cand_cols_t(const float* pos, const float* vel, const float* rho,
                    const float* mass, const int* idx, float* out,
                    long long pos_stride, long long vel_stride,
                    long long rho_stride, long long mass_stride, int m,
                    int nblocks, float rho0, float stiffness, void* stream) {
  if (m <= 0 || nblocks <= 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = pos;
  a.vel = vel;
  a.rho = rho;
  a.mass = mass;
  a.idx = idx;
  a.out = out;
  a.pos_stride = pos_stride;
  a.vel_stride = vel_stride;
  a.rho_stride = rho_stride;
  a.mass_stride = mass_stride;
  a.m = m;
  a.rho0 = rho0;
  a.stiffness = stiffness;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx != nullptr)
    cand_cols_t<true><<<nblocks, kTile, 0, s>>>(a);
  else
    cand_cols_t<false><<<nblocks, kTile, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
