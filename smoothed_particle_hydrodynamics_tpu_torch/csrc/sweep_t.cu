// Exact-mode neighbor sweeps over the cell-sorted particle frame, for NVIDIA
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_t.py, whose
// density_t_plain / force_t_plain are the PyTorch versions of the same sums.
//
// K1 density_kernel_t replaces _density_kernel_t and K2 force_kernel_t
// replaces _force_kernel_t, both in
// smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py (exact branch).
//
// What they compute.  Particles are sorted by linear cell id
// (z*ny + y)*nx + x, so each of the 9 (dy, dz) stencil rods of a block of b
// consecutive sorted particles is one contiguous row window
// [ws, ws + wc*s_t) of the sorted frame (the window tables of
// _block_windows_t).  A pair (i, j) counts when
//     |cid_j - cid_i - delta_rod| <= 1  and  j != i  and  d^2 < h^2,
// with d^2 in world coordinates.  K1 sums rho_i = sum m_j poly6(d) and the
// neighbor count (plus the self term when include_self is set); K2 sums the
// pressure term sum (x_i - x_j) (h-d)^2 (m_j pw_i + m_j pw_j) / (d+eps)
// and the viscosity term sum (v_j - v_i) (h-d) m_j / rho_j, then applies
// mu/rho_i and the Laplacian norm, as the TPU kernels do after their sweep.
//
// Design.  One CUDA block per block of b sorted particles, one thread per
// particle.  For each rod the block walks the window in tiles of b rows:
// every thread stages one candidate row into shared memory, then every
// thread tests the whole tile against its own particle and sums in
// registers.  The TPU kernels' DMA double-buffering, 128-lane row padding,
// per-block reference point and MXU reductions are not carried over: the
// window walk is bounded by the particle count instead of padding rows, and
// the sums are direct per-pair sums (acc then differs from the TPU's only by
// reassociation).  Cell ids are int32 (the TPU kernels carry them as f32).
//
// What bounds it.  The instruction rate of the pair tests: every thread
// tests 9 windows of about (block extent + 2 cells) rows, of which a few
// percent are neighbors, so most of the instruction stream is the d^2 and cid mask
// of rejected pairs.  Candidate loads are small next to that (each tile row
// is read once per block and reused by b threads from shared memory).  The
// design does nothing yet about the rejected pairs or the divergence of the
// force's sqrt/divide under the mask; tighter windows, warp-level tiling and
// tensor-core reductions are later work.
//
// Rounding.  d^2 and t = h_scaled^2 - d^2 * scale^2 are formed with
// explicitly rounded intrinsics (no FMA contraction), so the mask sees the
// same bits as the plain PyTorch version's separate multiplies and adds and
// neighbor counts agree exactly; the build also passes --fmad=false so the
// rest of the arithmetic rounds op by op as well.

#include <cuda_runtime.h>

namespace {

constexpr int kRods = 9;
// force candidate columns: x y z rimj*vx rimj*vy rimj*vz rimj mj mj*pwj
constexpr int kForceCols = 9;

// Rod r of [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]: its linear
// cell-id offset (dz * ny + dy) * nx.
__device__ __forceinline__ int rod_delta(int r, int nx, int ny) {
  const int dy = r / 3 - 1;
  const int dz = r % 3 - 1;
  return (dz * ny + dy) * nx;
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool pair_ok(int cid_j, int cid_i, int delta,
                                        int j, int i, float d2, float h2) {
  const int dc = cid_j - cid_i - delta;
  return dc >= -1 && dc <= 1 && j != i && d2 < h2;
}

struct DensityArgs {
  const float* pos;   // [n, 3] sorted positions
  const float* mass;  // [n]
  const int* cid;     // [n] sorted (frozen) cell ids
  const int* ws;      // [nblocks * 9] window starts
  const int* wc;      // [nblocks * 9] window chunk counts
  float* rho;         // [n] out
  int* ncount;        // [n] out
  int n, s_t, nx, ny, include_self;
  float h2, h_scaled2, scale2, poly6;
};

__global__ void density_kernel_t(DensityArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  float* sx = smem;
  float* sy = sx + b;
  float* sz = sy + b;
  float* sm = sz + b;
  int* sc = reinterpret_cast<int*>(sm + b);

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int i = blk * b + tid;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    ci = a.cid[i];
  }
  float rho = 0.f;
  int count = 0;
  for (int r = 0; r < kRods; ++r) {
    const int delta = rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int stop = min(start + a.wc[blk * kRods + r] * a.s_t, a.n);
    for (int t0 = start; t0 < stop; t0 += b) {
      const int j = t0 + tid;
      if (j < stop) {
        sx[tid] = a.pos[3 * j];
        sy[tid] = a.pos[3 * j + 1];
        sz[tid] = a.pos[3 * j + 2];
        sm[tid] = a.mass[j];
        sc[tid] = a.cid[j];
      }
      __syncthreads();
      const int len = min(b, stop - t0);
      if (live) {
        for (int k = 0; k < len; ++k) {
          const float d2 = dist2(sx[k] - xi, sy[k] - yi, sz[k] - zi);
          if (pair_ok(sc[k], ci, delta, t0 + k, i, d2, a.h2)) {
            const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
            const float w3 = a.poly6 * t * t * t;
            rho += sm[k] * w3;
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
      rho += a.mass[i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

struct ForceArgs {
  const float* pos;   // [n, 3] sorted positions
  const float* vel;   // [n, 3] sorted velocities
  const float* rho;   // [n] densities from K1
  const float* cand;  // [n, kForceCols] candidate columns (fused_cand_cols)
  const int* cid;     // [n]
  const int* ws;      // [nblocks * 9]
  const int* wc;      // [nblocks * 9]
  float* acc;         // [n, 3] out: hydro acceleration
  int n, s_t, nx, ny;
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

__global__ void force_kernel_t(ForceArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  float* sf = smem;  // column c of the tile at sf[c * b + row]
  int* sc = reinterpret_cast<int*>(smem + kForceCols * b);

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int i = blk * b + tid;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 1.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    vxi = a.vel[3 * i];
    vyi = a.vel[3 * i + 1];
    vzi = a.vel[3 * i + 2];
    rhoi = a.rho[i];
    ci = a.cid[i];
  }
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = (rhoi - a.rho0) * a.stiffness * rhoi_inv * rhoi_inv;

  float ax = 0.f, ay = 0.f, az = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const int delta = rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int stop = min(start + a.wc[blk * kRods + r] * a.s_t, a.n);
    for (int t0 = start; t0 < stop; t0 += b) {
      const int j = t0 + tid;
      if (j < stop) {
        const float* row = a.cand + static_cast<long long>(j) * kForceCols;
        for (int c = 0; c < kForceCols; ++c) sf[c * b + tid] = row[c];
        sc[tid] = a.cid[j];
      }
      __syncthreads();
      const int len = min(b, stop - t0);
      if (live) {
        for (int k = 0; k < len; ++k) {
          const float dx = sf[k] - xi;
          const float dy = sf[b + k] - yi;
          const float dz = sf[2 * b + k] - zi;
          const float d2 = dist2(dx, dy, dz);
          if (pair_ok(sc[k], ci, delta, t0 + k, i, d2, a.h2)) {
            const float d = sqrtf(d2) * a.scale;
            const float hd = a.h - d;
            const float num = (hd * hd) * (sf[7 * b + k] * pw_i + sf[8 * b + k]);
            const float center = num / (d + a.eps) * a.scale;
            ax -= dx * center;
            ay -= dy * center;
            az -= dz * center;
            const float rim = sf[6 * b + k];
            vx += (sf[3 * b + k] - vxi * rim) * hd;
            vy += (sf[4 * b + k] - vyi * rim) * hd;
            vz += (sf[5 * b + k] - vzi * rim) * hd;
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

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused.
int sph_density_t(const float* pos, const float* mass, const int* cid,
                  const int* ws, const int* wc, float* rho, int* ncount,
                  int n, int block, int s_t, int nx, int ny, int include_self,
                  float h2, float h_scaled2, float scale2, float poly6,
                  void* stream) {
  DensityArgs a;
  a.pos = pos;
  a.mass = mass;
  a.cid = cid;
  a.ws = ws;
  a.wc = wc;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.s_t = s_t;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  const int nblocks = (n + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * 5 * sizeof(float);
  density_kernel_t<<<nblocks, block, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sph_force_t(const float* pos, const float* vel, const float* rho,
                const float* cand, const int* cid, const int* ws,
                const int* wc, float* acc, int n, int block, int s_t, int nx,
                int ny, float h2, float h, float scale, float eps,
                float stiffness, float rho0, float viscosity, float visc_norm,
                void* stream) {
  ForceArgs a;
  a.pos = pos;
  a.vel = vel;
  a.rho = rho;
  a.cand = cand;
  a.cid = cid;
  a.ws = ws;
  a.wc = wc;
  a.acc = acc;
  a.n = n;
  a.s_t = s_t;
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
  const int nblocks = (n + block - 1) / block;
  const size_t smem =
      static_cast<size_t>(block) * (kForceCols + 1) * sizeof(float);
  force_kernel_t<<<nblocks, block, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
