// Lane-layout neighbor sweeps for NVIDIA Hopper (sm_90a): the eager
// (rebin-every-step) path of pallas_layout="lane".  Plain C interface, loaded
// with ctypes by smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_lane.py,
// whose density_lane_plain / force_lane_plain are the PyTorch versions of the
// same sums.
//
// Replaces, in smoothed_particle_hydrodynamics_tpu/ops/pallas_step.py:
//   density_kernel_lane <- _density_kernel (:196, called at :417);
//   force_kernel_lane   <- _force_kernel   (:244, called at :450).
// Each launches once per step, over every block of the sorted frame.
//
// These kernels share no device code with sweep_t.cu: they are a second,
// independent implementation of the same pair physics, against which the
// sublane kernels can be held on the card (and the other way round).
//
// What they compute.  Particles are sorted by linear cell id
// (z*ny + y)*nx + x, and their fields are rows of one table
// fields[F][n_pad]: density x y z m cid, force x y z vx vy vz m rho cid, the
// cid row holding int32 bits, rows [n, n_pad) padding (zeros, cid -2^30).
// Block b of `block` sorted rows walks, for each of the 9 (dy, dz) rods, the
// rows [ws, ws + wc*window) of the table (ws 128-aligned, wc <= 127 chunks of
// `window` rows, from the window table).  A pair (i, j) counts when
//     |cid_j - cid_i - delta_rod| <= 1  and  j != i  and  d^2 < h^2,
// with dx = x_i - x_j and d^2 = dx*dx + dy*dy + dz*dz.  The density kernel
// sums m_j poly6_norm t^3, t = h_scaled^2 - d^2 scale^2, and the neighbor
// count, plus the self term when include_self is set.  The force kernel forms
// per pair p_j = (rho_j - rho0) k, 1/rho_j (rho_j > 0, else 1),
// pweight = pw_i + p_j/rho_j^2, and sums the pressure term
// dx (h-d)^2 (m_j pweight)/(d+eps) scale and the viscosity term
// (v_j - v_i) (h-d) m_j/rho_j; the epilogue is (mu/rho_i v + a) visc_norm.
//
// Design.  One CUDA block per block of sorted rows, one thread per row.  For
// each rod the block stages one chunk of `window` candidate rows of every
// field in shared memory (each thread copies window/block rows), then each
// thread tests the whole chunk against its own particle and sums in
// registers.  The TPU kernels' tiled [n_pad/128, F, 128] DMA layout, double
// buffering and split grids are not carried over.  Rows of the last block
// beyond n are staged for their block but neither computed nor written.
//
// What bounds it.  The instruction rate of the pair tests: a thread tests
// 9 rods x wc x window rows, whole chunks (the 128-aligned start and the
// chunk rounding add rows outside the true rod window), of which under one
// percent are neighbors (~4700 rows tested for ~29 neighbors at the 1M
// splash).  The least time for the same work on an H100 is far below that:
// at the 1M splash the density kernel must move ~29 MB (each field row read
// once, the outputs written once), ~9 us at 3.35 TB/s, above its 15 flops
// on each of ~2.9e7 pairs within h at 67 TFLOP/s f32; the force kernel's
// 40 flops a pair, ~17 us, are above its ~49 MB.  Both kernels take
// milliseconds (one launch each per step): the rejected pair tests are the
// cost.  Tighter windows (true window ends, no alignment) and warp-level
// tiling are later work.
//
// Rounding.  d^2 and t are formed with explicitly rounded intrinsics (no FMA
// contraction), so the mask sees the same bits as the plain PyTorch version's
// separate multiplies and adds; the build also passes --fmad=false so the
// rest of the arithmetic rounds op by op as well.

#include <cuda_runtime.h>

namespace {

constexpr int kRods = 9;
constexpr int kDensityFields = 5;  // x y z m cid
constexpr int kForceFields = 9;    // x y z vx vy vz m rho cid
constexpr int kPadCid = -(1 << 30);

// Linear cell-id offset of rod r of [(dy, dz) for dy in (-1, 0, 1)
// for dz in (-1, 0, 1)]: (dz * ny + dy) * nx.
__device__ __forceinline__ int lane_rod_delta(int r, int nx, int ny) {
  const int dy = r / 3 - 1;
  const int dz = r % 3 - 1;
  return (dz * ny + dy) * nx;
}

// |cid_j - cid_i - delta| <= 1 in wrapping unsigned arithmetic: the pad rows'
// -2^30 lands far outside every band instead of overflowing.
__device__ __forceinline__ bool lane_in_band(int cid_j, int cid_i, int delta) {
  return static_cast<unsigned>(cid_j) - static_cast<unsigned>(cid_i) -
             static_cast<unsigned>(delta) + 1u <=
         2u;
}

__device__ __forceinline__ float lane_dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Copy rows [base, base + window) of `nf` field rows into shared memory,
// field f at s[f * window + k]; rows at or past n_pad (none, for a table
// built by _block_windows) read as padding.
__device__ __forceinline__ void stage_chunk(float* s, const float* fields,
                                            int nf, int n_pad, int base,
                                            int window) {
  for (int k = threadIdx.x; k < window; k += blockDim.x) {
    const int j = base + k;
    const bool in = j < n_pad;
    for (int f = 0; f < nf - 1; ++f) {
      s[f * window + k] =
          in ? fields[static_cast<long long>(f) * n_pad + j] : 0.f;
    }
    s[(nf - 1) * window + k] =
        in ? fields[static_cast<long long>(nf - 1) * n_pad + j]
           : __int_as_float(kPadCid);
  }
}

struct LaneDensityArgs {
  const float* fields;  // [5, n_pad]: x y z m, cid bits
  const int* ws;        // [nblocks * 9] window starts
  const int* wc;        // [nblocks * 9] chunk counts
  float* rho;           // [n] out
  int* ncount;          // [n] out
  int n, n_pad, window, nx, ny, include_self;
  float h2, h_scaled2, scale2, poly6;
};

__global__ void density_kernel_lane(LaneDensityArgs a) {
  extern __shared__ float smem[];
  const int s = a.window;
  const float* sx = smem;
  const float* sy = sx + s;
  const float* sz = sy + s;
  const float* sm = sz + s;
  const float* sc = sm + s;

  const int blk = blockIdx.x;
  const int i = blk * blockDim.x + threadIdx.x;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[a.n_pad + i];
    zi = a.fields[2 * a.n_pad + i];
    ci = __float_as_int(a.fields[4 * a.n_pad + i]);
  }
  float rho = 0.f;
  int count = 0;
  for (int r = 0; r < kRods; ++r) {
    const int delta = lane_rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int chunks = a.wc[blk * kRods + r];
    for (int c = 0; c < chunks; ++c) {
      const int base = start + c * s;
      stage_chunk(smem, a.fields, kDensityFields, a.n_pad, base, s);
      __syncthreads();
      if (live) {
        for (int k = 0; k < s; ++k) {
          const float d2 = lane_dist2(xi - sx[k], yi - sy[k], zi - sz[k]);
          if (lane_in_band(__float_as_int(sc[k]), ci, delta) && base + k != i &&
              d2 < a.h2) {
            const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
            const float w = a.poly6 * t * t * t;
            rho += sm[k] * w;
            ++count;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.fields[3 * a.n_pad + i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

struct LaneForceArgs {
  const float* fields;  // [9, n_pad]: x y z vx vy vz m rho, cid bits
  const int* ws;        // [nblocks * 9]
  const int* wc;        // [nblocks * 9]
  float* acc;           // [n, 3] out: hydro acceleration
  int n, n_pad, window, nx, ny;
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

__global__ void force_kernel_lane(LaneForceArgs a) {
  extern __shared__ float smem[];
  const int s = a.window;
  const int blk = blockIdx.x;
  const int i = blk * blockDim.x + threadIdx.x;
  const bool live = i < a.n;
  const long long np = a.n_pad;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[np + i];
    zi = a.fields[2 * np + i];
    vxi = a.fields[3 * np + i];
    vyi = a.fields[4 * np + i];
    vzi = a.fields[5 * np + i];
    rhoi = a.fields[7 * np + i];
    ci = __float_as_int(a.fields[8 * np + i]);
  }
  const float p_i = (rhoi - a.rho0) * a.stiffness;
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = p_i * rhoi_inv * rhoi_inv;

  float ax = 0.f, ay = 0.f, az = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const int delta = lane_rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int chunks = a.wc[blk * kRods + r];
    for (int c = 0; c < chunks; ++c) {
      const int base = start + c * s;
      stage_chunk(smem, a.fields, kForceFields, a.n_pad, base, s);
      __syncthreads();
      if (live) {
        for (int k = 0; k < s; ++k) {
          const float dx = xi - smem[k];
          const float dy = yi - smem[s + k];
          const float dz = zi - smem[2 * s + k];
          const float d2 = lane_dist2(dx, dy, dz);
          if (lane_in_band(__float_as_int(smem[8 * s + k]), ci, delta) &&
              base + k != i && d2 < a.h2) {
            const float mj = smem[6 * s + k];
            const float rhoj = smem[7 * s + k];
            const float d = sqrtf(d2) * a.scale;
            const float hd = a.h - d;
            const float p_j = (rhoj - a.rho0) * a.stiffness;
            const float rhoj_inv = 1.f / (rhoj > 0.f ? rhoj : 1.f);
            const float pweight = pw_i + p_j * rhoj_inv * rhoj_inv;
            const float center = (hd * hd) * (mj * pweight) / (d + a.eps) * a.scale;
            ax += dx * center;
            ay += dy * center;
            az += dz * center;
            const float vweight = hd * (rhoj_inv * mj);
            vx += (smem[3 * s + k] - vxi) * vweight;
            vy += (smem[4 * s + k] - vyi) * vweight;
            vz += (smem[5 * s + k] - vzi) * vweight;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] = mu_rhoi * vx * a.visc_norm + ax * a.visc_norm;
    a.acc[3 * i + 1] = mu_rhoi * vy * a.visc_norm + ay * a.visc_norm;
    a.acc[3 * i + 2] = mu_rhoi * vz * a.visc_norm + az * a.visc_norm;
  }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) over
// ceil(n / block) blocks of `block` threads and returns cudaGetLastError():
// nonzero when the launch was refused.
int sph_density_lane(const float* fields, const int* ws, const int* wc,
                     float* rho, int* ncount, int n, int n_pad, int block,
                     int window, int nx, int ny, int include_self, float h2,
                     float h_scaled2, float scale2, float poly6,
                     void* stream) {
  LaneDensityArgs a;
  a.fields = fields;
  a.ws = ws;
  a.wc = wc;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.n_pad = n_pad;
  a.window = window;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  const size_t smem = static_cast<size_t>(kDensityFields) * window * sizeof(float);
  const cudaError_t err = allow_smem(density_kernel_lane, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (n + block - 1) / block;
  density_kernel_lane<<<nblocks, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sph_force_lane(const float* fields, const int* ws, const int* wc,
                   float* acc, int n, int n_pad, int block, int window,
                   int nx, int ny, float h2, float h, float scale, float eps,
                   float stiffness, float rho0, float viscosity,
                   float visc_norm, void* stream) {
  LaneForceArgs a;
  a.fields = fields;
  a.ws = ws;
  a.wc = wc;
  a.acc = acc;
  a.n = n;
  a.n_pad = n_pad;
  a.window = window;
  a.nx = nx;
  a.ny = ny;
  a.h2 = h2;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  const size_t smem = static_cast<size_t>(kForceFields) * window * sizeof(float);
  const cudaError_t err = allow_smem(force_kernel_lane, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (n + block - 1) / block;
  force_kernel_lane<<<nblocks, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
