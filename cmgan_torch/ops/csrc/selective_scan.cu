// Mamba-1's selective scan and its causal depthwise convolution, forward,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no state-space layer. Added for
// SEMamba's TF-Mamba blocks (cmgan_torch/models/semamba.py), whose bidirectional
// Mamba-1 layers run along time (B*F' rows of T steps) and along frequency (B*T
// rows of F' steps). Launched by ops/selective_scan.py, which holds the plain
// versions of both kernels.
//
// The scan, for each row, channel d < D and state n < N = 16, in the order of
// the row's steps (last to first where `reverse`):
//
//   delta_t = softplus(dt_t . dt_w[d] + dt_bias[d])
//   h_t[n]  = exp(delta_t * A[d, n]) * h_{t-1}[n] + delta_t * u_t[d] * B_t[n]
//   y_t[d]  = (sum_n h_t[n] * C_t[n] + Dskip[d] * u_t[d]) * silu(z_t[d])
//
// with h_{-1} = 0. dt_t [R], B_t and C_t [N] are a step's, shared by the row's
// channels. y is written at the step's own position, so a reverse scan of the
// sequence as it lies is the scan of the flipped sequence, flipped back.
//
// What bounds it on an H100 SXM: its operand bytes (u, delta, z and y of D
// floats a step, B and C of N; about 4.2 kB a step at D 256) against 3.35
// TB/s, and, as close behind, its exponentials: one a (step, channel, state),
// 4096 a step, on the SFU's 16 a clock and SM (about 0.9 of the bytes' time).
// So the kernel keeps every state in registers (never [steps, D, N] in memory),
// reads each operand once, takes delta's rank-R product and softplus itself
// (it reads dt, R floats a step, in place of delta's D), and keeps enough
// exponentials in flight:
//
//   - a block owns one row and GROUPS groups of 32 channels, a warp a group
//     and a lane a channel, so every load of u, z and y is 128 contiguous
//     bytes a warp; the row's dt, B and C for a chunk of CHUNK steps are
//     staged once in shared memory and read back as broadcasts;
//   - a warp walks the row's chunks in order, the state carried in registers
//     from one chunk to the next, loading the next step's u and z while it
//     computes this one's; the steps are a loop, the 16 states unrolled inside
//     it: the code stays small (a fully unrolled chunk thrashed the
//     instruction cache) and a thread needs 72 registers, so many warps share
//     an SM; dt_rank stays a run-time value (a build with it fixed at 4 ran
//     2-5% slower on the H100, PERF.md);
//   - rows are not split over warps: at 800 rows of 2561 steps the walk's 6400
//     warps already fill the card, and a split that scanned each run twice
//     (once for its end state, once from the true state) took 13.0 ms there
//     against the walk's 5.6 on the H100 (PERF.md).
//
// No atomics and a fixed order of every sum: two runs are bitwise equal.
//
// The causal convolution (`causal_conv1d_silu`): y_t[d] = silu(bias[d] +
// sum_k w[d, k] * u_{t-K+1+k}[d]) with zeros before the row (after it, reverse),
// K = 4. A thread owns one channel and a run of 16 steps, its K-1 steps of
// history loaded beside them; bound by bytes (read u once, write y once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int N = 16;      // d_state, held in registers
constexpr int MAX_R = 8;   // the widest dt_rank taken
constexpr int GROUPS = 4;  // groups of 32 channels a block: d_inner % 128 == 0
constexpr int K = 4;       // d_conv
constexpr int CONV_STEPS = 16;
constexpr int CHUNK = 32;  // steps a chunk of the scan

struct Operand {  // a [rows, L, X] tensor with unit stride along X
  const float* p;
  long long row, t;
};

struct ScanArgs {
  Operand u, dt, B, C, z;
  float* y;               // [rows, L, D], contiguous
  const float* dt_w;      // [D, R]
  const float* dt_bias;   // [D]
  const float* A;         // [D, N]
  const float* Dskip;     // [D]
  int L, D, R, reverse;
};

__device__ __forceinline__ float softplus(float x) { return x <= 20.f ? log1pf(expf(x)) : x; }
// 2^x on the SFU, one instruction (2 ulp; results below 2^-126 flush to zero,
// where a decay exp(delta * A) adds nothing a float32 state can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// One block: a row and GROUPS groups of 32 channels; chunks of CHUNK steps,
// whose dt (padded to RP floats), B and C are staged in shared memory.
__global__ void __launch_bounds__(32 * GROUPS)
selective_scan_fwd(ScanArgs a) {
  __shared__ __align__(16) float stage[CHUNK * (MAX_R + 2 * N)];
  const int RP = (a.R + 3) & ~3;
  const int RS = RP + 2 * N;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int blocks_a_row = a.D / (32 * GROUPS);
  const long long row = blockIdx.x / blocks_a_row;
  const int d = ((blockIdx.x % blocks_a_row) * GROUPS + grp) * 32 + lane;

  float a2[N], h[N], w[MAX_R];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = a.A[d * N + n] * LOG2E;
    h[n] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) w[r] = r < a.R ? a.dt_w[d * a.R + r] : 0.f;
  const float bias = a.dt_bias[d], dskip = a.Dskip[d];
  const float* u = a.u.p + row * a.u.row + d;
  const float* z = a.z.p + row * a.z.row + d;
  float* y = a.y + row * a.L * static_cast<long long>(a.D) + d;
  const float* dtp = a.dt.p + row * a.dt.row;
  const float* Bp = a.B.p + row * a.B.row;
  const float* Cp = a.C.p + row * a.C.row;

  for (int c0 = 0; c0 < a.L; c0 += CHUNK) {
    __syncthreads();  // the last chunk's reads of shared memory are done
    const int steps = min(CHUNK, a.L - c0);
    for (int i = threadIdx.x; i < steps * RS; i += blockDim.x) {
      const int s = i / RS, k = i - s * RS;
      const long long t = a.reverse ? a.L - 1 - (c0 + s) : c0 + s;
      float v = 0.f;
      if (k < a.R) {
        v = dtp[t * a.dt.t + k];
      } else if (k >= RP && k < RP + N) {
        v = Bp[t * a.B.t + (k - RP)];
      } else if (k >= RP + N) {
        v = Cp[t * a.C.t + (k - RP - N)];
      }
      stage[i] = v;
    }
    __syncthreads();

    // u and z of the next step are loaded while this one is computed
    long long t = a.reverse ? a.L - 1 - c0 : c0;
    float uv = u[t * a.u.t], zv = z[t * a.z.t];
    for (int i = 0; i < steps; ++i) {
      const long long tn = a.reverse ? t - 1 : t + 1;
      float un = 0.f, zn = 0.f;
      if (i + 1 < steps) un = u[tn * a.u.t], zn = z[tn * a.z.t];
      const float* st = stage + i * RS;
      float x = bias;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < a.R) x += st[r] * w[r];
      }
      const float dl = softplus(x), du = dl * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 b = *reinterpret_cast<const float4*>(st + RP + n);
        const float4 c = *reinterpret_cast<const float4*>(st + RP + N + n);
        h[n] = ex2(dl * a2[n]) * h[n] + du * b.x;
        h[n + 1] = ex2(dl * a2[n + 1]) * h[n + 1] + du * b.y;
        h[n + 2] = ex2(dl * a2[n + 2]) * h[n + 2] + du * b.z;
        h[n + 3] = ex2(dl * a2[n + 3]) * h[n + 3] + du * b.w;
        acc += h[n] * c.x + h[n + 1] * c.y + h[n + 2] * c.z + h[n + 3] * c.w;
      }
      y[t * a.D] = (acc + dskip * uv) * silu(zv);
      t = tn, uv = un, zv = zn;
    }
  }
}

// A thread: one channel and CONV_STEPS steps of one row, in the order of the
// row's steps (last to first where `reverse`), its K - 1 steps of history
// loaded with them.
__global__ void __launch_bounds__(128)
causal_conv1d_silu(Operand x, const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ y, long long rows, int L, int D, int reverse) {
  const int runs = (L + CONV_STEPS - 1) / CONV_STEPS;
  const long long row = blockIdx.x / runs;
  const int p0 = (blockIdx.x % runs) * CONV_STEPS;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= rows || d >= D) return;
  const float* xr = x.p + row * x.row + d;
  float* yr = y + row * L * static_cast<long long>(D) + d;
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = w[d * K + k];
  const float b = bias[d];
  float win[CONV_STEPS + K - 1];
#pragma unroll
  for (int i = 0; i < CONV_STEPS + K - 1; ++i) {
    const int pos = p0 - (K - 1) + i;
    win[i] = 0.f;
    if (pos >= 0 && pos < L) win[i] = xr[static_cast<long long>(reverse ? L - 1 - pos : pos) * x.t];
  }
#pragma unroll
  for (int i = 0; i < CONV_STEPS; ++i) {
    const int pos = p0 + i;
    if (pos < L) {
      float acc = b;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += wk[k] * win[i + k];
      yr[static_cast<long long>(reverse ? L - 1 - pos : pos) * D] = silu(acc);
    }
  }
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronises. Operands are float32;
// each [rows, L, X] operand is given by its pointer and its row and step
// strides in elements (unit stride along X); y is contiguous [rows, L, D].
//
// The scan takes d_state 16, dt_rank 1 to 8 and D a multiple of 128 (4 groups
// of 32 channels a block); another shape is refused (cudaErrorInvalidValue).
extern "C" int cmgan_selective_scan_fwd(
    const void* u, long long u_row, long long u_t, const void* dt, long long dt_row,
    long long dt_t, const void* B, long long b_row, long long b_t, const void* C, long long c_row,
    long long c_t, const void* z, long long z_row, long long z_t, const void* dt_w,
    const void* dt_bias, const void* A, const void* Dskip, void* y, long long rows, int L, int D,
    int d_state, int R, int reverse, void* stream) {
  const long long grid = rows * (D / (32 * GROUPS));
  if (rows <= 0 || L <= 0 || D <= 0 || D % (32 * GROUPS) != 0 || d_state != N || R < 1 ||
      R > MAX_R || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a{{static_cast<const float*>(u), u_row, u_t},
             {static_cast<const float*>(dt), dt_row, dt_t},
             {static_cast<const float*>(B), b_row, b_t},
             {static_cast<const float*>(C), c_row, c_t},
             {static_cast<const float*>(z), z_row, z_t},
             static_cast<float*>(y),
             static_cast<const float*>(dt_w),
             static_cast<const float*>(dt_bias),
             static_cast<const float*>(A),
             static_cast<const float*>(Dskip),
             L, D, R, reverse};
  selective_scan_fwd<<<static_cast<unsigned>(grid), 32 * GROUPS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cmgan_causal_conv1d_silu(const void* x, long long x_row, long long x_t,
                                        const void* w, const void* bias, void* y, long long rows,
                                        int L, int D, int d_conv, int reverse, void* stream) {
  if (rows <= 0 || L <= 0 || D <= 0 || d_conv != K) return static_cast<int>(cudaErrorInvalidValue);
  const long long runs = (L + CONV_STEPS - 1) / CONV_STEPS;
  if (rows * runs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows * runs), (D + 127) / 128);
  causal_conv1d_silu<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      {static_cast<const float*>(x), x_row, x_t}, static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), rows, L, D, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
