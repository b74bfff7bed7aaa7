// The leapfrog integrator as one pass over the particles, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/ops/integrate.py, whose
// kdk_integrate_plain (the kick, the drift, reflect_boundary and
// energy_tally) is the PyTorch version of the same update.
//
// Replaces no TPU kernel.  The JAX package's ops/integrate.py is plain jnp,
// which XLA fuses into one pass over the particles; run eagerly in PyTorch
// the same update is about 45 launches over [N, 3] and [N] arrays (the kick
// and the drift 4, the wall reflection about 28, the tally about 15 with a
// [N, 5] stack and its column sum), each reading and writing device memory
// once, and two pageable host copies of constants.
//
// What it computes, per particle row, in the twin's order of operations:
//   1. v_half = v + a (dt/2), x' = x + v_half (dt/sim_scale);
//   2. the closing kick: second_kick "gravity" adds the central point mass's
//      pull at x' times dt (physics.central_gravity), "none" adds nothing;
//   3. boundary "reflect": reflect_boundary's wall intersection, damped
//      remainder and velocity flip, then its clamp into [0, box];
//   4. the tally's terms at the new state: KE (masked where v^2 is not
//      finite), PE (G M m / (|r| + eps), or the (r_x + r_y + r_z) * 0
//      canary when G M = 0) and L = m (r x v) about the centre; in compat
//      mode the reference's: at-rest particles left out, PE over
//      (|r| + eps)^3, no L.
// Each product, sum, quotient and square root rounds once, as each of the
// twin's tensor ops does (__f*_rn intrinsics; the library is built with
// --fmad=false besides), except inside the cross product r x v, which
// torch's own CUDA kernel computes with one FMA a component (cross_t),
// 1/x is the IEEE reciprocal (the twin's
// reciprocal() * 1.0), and the clamps are torch's: NaN is tested first and
// passed on, so a non-finite position stays visible; only then does
// fmaxf/fminf pick, as in torch's own clamp_min and minimum kernels, and a
// squared norm adds as torch's CUDA reduction over the last axis does,
// (x^2 + z^2) + y^2 (sq3).  So positions and velocities equal the twin's on
// the card bit for bit in every mode (NaNs aside, whose payloads carry no
// value).
//
// The tally's terms are summed in float64 registers over a grid-stride loop,
// then per block by warp shuffles and one pass over the warps' sums, into
// kTerms partials a block; a second launch of one block sums the partials in
// a fixed order and writes KE, -PE, the L vector and |L| (the norm of the
// float64 sums), each rounded once to float32.  No
// atomics: for a given N and grid the tally's bits do not change from call
// to call.  The twin sums in float32 (torch's reduction order), so the two
// tallies differ by the twin's rounding.
//
// What bounds it: bytes.  It reads position, velocity, acceleration and mass
// (40 B a particle) and writes position and velocity (24 B), 64 B a particle
// with no reuse, 0.191 ms at 10M particles at 3.35 TB/s; the arithmetic is a
// few dozen operations a row.  The design keeps every intermediate in
// registers (no [N, 3] temporaries, no [N, 5] stack), runs a persistent grid
// of a few blocks an SM so the partials do not grow with N, and lets a warp's
// loads of 32 consecutive [N, 3] rows (384 contiguous bytes a field) fill
// whole cache lines, the y and z words served from L1 after the x load.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, both launches
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 5;      // partials a block: KE, PE, Lx, Ly, Lz
constexpr unsigned kFullMask = 0xffffffffu;

// The closing kick, the box and the tally's form.
enum Kick : int { kKickNone = 0, kKickGravity = 1 };
enum Tally : int { kTallyCanary = 0, kTallyPotential = 1, kTallyCompat = 2 };

struct Args {
  const float* pos;
  const float* vel;
  const float* acc;
  const float* mass;
  float* pos_out;
  float* vel_out;
  double* partials;  // [gridDim.x, kTerms]
  int n;
  float dt_half;     // f32(dt * 0.5)
  float pos_dt;      // f32(dt * f32(1 / sim_scale))
  float dt;
  float sim_scale;
  float damping;
  float gm_kick;     // f32(-G * M): the closing kick's factor
  float gm;          // f32(G * M): the potential's
  float softening;
  float center[3];
  float box[3];
};

// torch.clamp(v, min=lim) and torch.minimum(a, b) on the card: NaN first.
__device__ __forceinline__ float clamp_min_t(float v, float lim) {
  return isnan(v) ? v : fmaxf(v, lim);
}

__device__ __forceinline__ float minimum_t(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// One axis of reflect_boundary: the new position's axis np, velocity nv and
// the old position op; returns the clamped position, flips nv on a crossing.
__device__ __forceinline__ float reflect_axis(float op, float np, float& nv,
                                              float box, float damping) {
  const bool below = np < 0.0f;
  const bool above = np > box;
  const bool crossed = below || above;
  const float disp = __fsub_rn(np, op);
  const float inv = __frcp_rn(disp == 0.0f ? 1e-30f : disp);
  const float f_low = __fmul_rn(-op, inv);
  const float f_high = __fmul_rn(__fsub_rn(box, op), inv);
  const float f_hit = below ? f_low : (above ? f_high : 0.0f);
  nv = crossed ? -nv : nv;
  const float inter = __fadd_rn(op, __fmul_rn(disp, f_hit));
  const float rem = clamp_min_t(__fsub_rn(1.0f, f_hit), 0.0f);
  const float bounced =
      __fsub_rn(inter, __fmul_rn(disp, __fmul_rn(rem, damping)));
  return minimum_t(clamp_min_t(crossed ? bounced : np, 0.0f), box);
}

// One component a b - c d of torch.linalg.cross on the card: torch's CUDA
// kernel writes it as a product minus a product, which nvcc contracts into
// one FMA of the first product with the rounded second.
__device__ __forceinline__ float cross_t(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// (x * x + y * y + z * z) as torch's CUDA sum over the last axis of size 3
// adds the squares: (x^2 + z^2) + y^2.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

// Sums v over the block into every thread's v (warp shuffles, then warp 0
// over the warps' sums, in a fixed order); `smem` holds kWarps values.
__device__ __forceinline__ double block_sum(double v, double* smem) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFullMask, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s += smem[w];
  return s;
}

template <int kKick, bool kReflect, int kTally>
__global__ void __launch_bounds__(kThreads, 4) integrate_t(Args a) {
  double t[kTerms] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n; i += stride) {
    float op[3], x[3], v[3];
    for (int k = 0; k < 3; ++k) {
      op[k] = __ldg(a.pos + 3 * i + k);
      v[k] = __fadd_rn(__ldg(a.vel + 3 * i + k),
                       __fmul_rn(__ldg(a.acc + 3 * i + k), a.dt_half));
      x[k] = __fadd_rn(op[k], __fmul_rn(v[k], a.pos_dt));
    }
    const float m = __ldg(a.mass + i);
    if (kKick == kKickGravity) {
      float r[3];
      for (int k = 0; k < 3; ++k)
        r[k] = __fmul_rn(__fsub_rn(x[k], a.center[k]), a.sim_scale);
      const float base =
          __fadd_rn(__fsqrt_rn(sq3(r[0], r[1], r[2])), a.softening);
      const float denom = __fmul_rn(__fmul_rn(base, base), base);
      for (int k = 0; k < 3; ++k)
        v[k] = __fadd_rn(
            v[k], __fmul_rn(__fdiv_rn(__fmul_rn(a.gm_kick, r[k]), denom),
                            a.dt));
    }
    if (kReflect)
      for (int k = 0; k < 3; ++k)
        x[k] = reflect_axis(op[k], x[k], v[k], a.box[k], a.damping);
    float* po = a.pos_out + 3 * i;
    float* vo = a.vel_out + 3 * i;
    for (int k = 0; k < 3; ++k) {
      po[k] = x[k];
      vo[k] = v[k];
    }

    float r[3];
    for (int k = 0; k < 3; ++k)
      r[k] = __fmul_rn(__fsub_rn(x[k], a.center[k]), a.sim_scale);
    const float v2 = sq3(v[0], v[1], v[2]);
    const float ke = __fmul_rn(__fmul_rn(0.5f, m), v2);
    if (kTally == kTallyCompat) {
      if (v2 > 0.0f) {
        const float base =
            __fadd_rn(__fsqrt_rn(sq3(r[0], r[1], r[2])), a.softening);
        t[0] += ke;
        t[1] += __fdiv_rn(__fmul_rn(a.gm, m),
                          __fmul_rn(__fmul_rn(base, base), base));
      }
      continue;
    }
    if (isfinite(v2)) t[0] += ke;
    if (kTally == kTallyPotential)
      t[1] += __fdiv_rn(__fmul_rn(a.gm, m),
                        __fadd_rn(__fsqrt_rn(sq3(r[0], r[1], r[2])),
                                  a.softening));
    else
      t[1] += __fmul_rn(__fadd_rn(__fadd_rn(r[0], r[1]), r[2]), 0.0f);
    t[2] += __fmul_rn(m, cross_t(r[1], v[2], r[2], v[1]));
    t[3] += __fmul_rn(m, cross_t(r[2], v[0], r[0], v[2]));
    t[4] += __fmul_rn(m, cross_t(r[0], v[1], r[1], v[0]));
  }
  __shared__ double smem[kWarps];
  for (int j = 0; j < kTerms; ++j) {
    const double s = block_sum(t[j], smem);
    if (threadIdx.x == 0) a.partials[blockIdx.x * kTerms + j] = s;
  }
}

// The second stage: one block sums the nblocks partials of each term in a
// fixed order and writes tally = [KE, -PE, Lx, Ly, Lz, |L|] (float32).
__global__ void __launch_bounds__(kThreads)
    tally_t(const double* partials, int nblocks, int compat, float* tally) {
  __shared__ double smem[kWarps];
  double s[kTerms];
  for (int j = 0; j < kTerms; ++j) {
    double v = 0.0;
    for (int b = threadIdx.x; b < nblocks; b += kThreads)
      v += partials[b * kTerms + j];
    s[j] = block_sum(v, smem);
  }
  if (threadIdx.x != 0) return;
  tally[0] = static_cast<float>(s[0]);
  tally[1] = -static_cast<float>(s[1]);
  if (compat) {
    for (int k = 2; k < 6; ++k) tally[k] = 0.0f;
    return;
  }
  for (int k = 0; k < 3; ++k) tally[2 + k] = static_cast<float>(s[2 + k]);
  tally[5] = static_cast<float>(sqrt(s[2] * s[2] + s[3] * s[3] + s[4] * s[4]));
}

template <int kKick, bool kReflect>
void launch_tally_form(const Args& a, int tally, int nblocks,
                       cudaStream_t s) {
  switch (tally) {
    case kTallyCanary:
      integrate_t<kKick, kReflect, kTallyCanary><<<nblocks, kThreads, 0, s>>>(a);
      break;
    case kTallyPotential:
      integrate_t<kKick, kReflect, kTallyPotential>
          <<<nblocks, kThreads, 0, s>>>(a);
      break;
    default:
      integrate_t<kKick, kReflect, kTallyCompat><<<nblocks, kThreads, 0, s>>>(a);
  }
}

}  // namespace

extern "C" {

// Launches the pass over n > 0 rows on `stream` (a cudaStream_t) in nblocks
// blocks, then the tally's one-block sum of their partials ([nblocks, 5]
// float64 scratch), and returns cudaGetLastError(): nonzero when a launch
// was refused or a flag is not one it takes.  kick: 0 none, 1 gravity;
// reflect: 0 or 1; tally: 0 the G M = 0 canary, 1 the potential, 2 compat.
// center and box are [3] host arrays.
int sph_integrate_t(const float* pos, const float* vel, const float* acc,
                    const float* mass, float* pos_out, float* vel_out,
                    double* partials, float* tally_out, int n, int nblocks,
                    int kick, int reflect, int tally, float dt_half,
                    float pos_dt, float dt, float sim_scale, float damping,
                    float gm_kick, float gm, float softening,
                    const float* center, const float* box, void* stream) {
  if (n <= 0 || nblocks <= 0 || kick < 0 || kick > 1 || reflect < 0 ||
      reflect > 1 || tally < 0 || tally > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = pos;
  a.vel = vel;
  a.acc = acc;
  a.mass = mass;
  a.pos_out = pos_out;
  a.vel_out = vel_out;
  a.partials = partials;
  a.n = n;
  a.dt_half = dt_half;
  a.pos_dt = pos_dt;
  a.dt = dt;
  a.sim_scale = sim_scale;
  a.damping = damping;
  a.gm_kick = gm_kick;
  a.gm = gm;
  a.softening = softening;
  for (int k = 0; k < 3; ++k) {
    a.center[k] = center[k];
    a.box[k] = box[k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kick == kKickGravity) {
    if (reflect)
      launch_tally_form<kKickGravity, true>(a, tally, nblocks, s);
    else
      launch_tally_form<kKickGravity, false>(a, tally, nblocks, s);
  } else {
    if (reflect)
      launch_tally_form<kKickNone, true>(a, tally, nblocks, s);
    else
      launch_tally_form<kKickNone, false>(a, tally, nblocks, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tally_t<<<1, kThreads, 0, s>>>(partials, nblocks, tally == kTallyCompat,
                                 tally_out);
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
