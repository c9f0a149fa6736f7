// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper
// (sm_90a), f32 and bf16.
//
// Replaces src/repro/kernels/lru_scan.py::lru_scan (the TPU Pallas
// kernel: grid (B, R/512, L/256) with time the sequential grid axis, the
// f32 carry in VMEM scratch across time blocks, a fori_loop stepping
// 256 rows of 512 lanes inside a block).
//
// Contract (that of the Pallas kernel and of the plain PyTorch version
// repro_torch/kernels/lru_scan.py::lru_scan_torch):
//   a, b, h (B, L, R) contiguous, of one type T (float or bf16); h0
//   (B, R) float32 or absent (zeros). Per channel (b, r), in f32:
//     h = h0;  for t in 0..L-1:  h = a_t * h + b_t;  out_t = round_T(h)
//   The multiply and the add round separately (__fmul_rn, __fadd_rn, no
//   contraction into an FMA), as the plain version's two tensor
//   operations do, so in f32 the two agree bit for bit.
//
// Bound: at the recurrentgemma-9b prefill shape (B 4, L 4096, R 4096,
// f32) a and b are read and h written once, 805 MB, 0.24 ms at
// 3.35 TB/s; 2 FLOP an element is nothing next to it. Only B * R =
// 16,384 channels run in parallel and each steps 4,096 times, so the
// kernel is bound by the latency of its dependent loads, not by bytes.
//
// Backward (reverse mode, f32 only; no TPU kernel has one: the JAX
// package differentiates its associative scan, and this is the same
// function's gradient). With upstream gradient g_t the adjoint of h_t is
//   lam_{L-1} = g_{L-1};  lam_t = a_{t+1} * lam_{t+1} + g_t,
// the same recurrence run from the end with the coefficient shifted by
// one step; the wrapper forms db = lam, da_t = lam_t * h_{t-1} and
// dh0 = a_0 * lam_0 from it. Reverse mode walks t from L-1 down to 0,
// reads g_t and a_{t+1} (0 past the end), and writes lam_t: the same
// bytes and the same one multiply and one add as the forward, rounded
// the same way, so it agrees bit for bit with autograd through the
// plain version (whose product a_{t+1} * lam_{t+1} and sum with g_t
// are the same two IEEE operations, which commute).
//
// Design. One thread per channel, 128 channels a block (blockIdx.x) of
// one batch row (blockIdx.y), so a warp's loads and stores of one time
// step are 128 consecutive bytes. The carry stays in a register. Loads
// run kU steps ahead: the next group of kU (a, b) pairs is requested
// before the current group's dependent multiply-adds, so a load's
// latency hides behind kU steps of work. The ragged edges (L not a
// multiple of kU, R not a multiple of 128) are masked here, not padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // channels per block
constexpr int kU = 16;           // time steps per load group

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Step s of the walk touches time t = s (forward) or t = L-1-s
// (reverse); its coefficient is a_t (forward) or a_{t+1} (reverse, 0
// past the end).
template <bool Reverse>
__device__ __forceinline__ int time_of(int s, int L) {
  return Reverse ? L - 1 - s : s;
}

template <bool Reverse, typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           size_t base, int s0, int L, int R,
                                           float* ga, float* gb) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int s = s0 + u;
    const int t = time_of<Reverse>(s, L);
    const int ta = Reverse ? t + 1 : t;
    gb[u] = s < L ? to_f32(b[base + static_cast<size_t>(t) * R]) : 0.f;
    ga[u] = s < L && ta < L ? to_f32(a[base + static_cast<size_t>(ta) * R])
                            : 0.f;
  }
}

template <bool Reverse, typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ h0, T* __restrict__ out, int L,
                int R, int has_h0) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int bi = blockIdx.y;
  const size_t base = static_cast<size_t>(bi) * L * R + r;
  float h = has_h0 ? h0[static_cast<size_t>(bi) * R + r] : 0.f;

  float ca[kU], cb[kU], na[kU], nb[kU];
  load_group<Reverse>(a, b, base, 0, L, R, ca, cb);
  for (int s0 = 0; s0 < L; s0 += kU) {
    load_group<Reverse>(a, b, base, s0 + kU, L, R, na, nb);  // masked past L
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = s0 + u;
      if (s < L) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        out[base + static_cast<size_t>(time_of<Reverse>(s, L)) * R] =
            from_f32<T>(h);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

template <bool Reverse, typename T>
int launch_typed(const void* a, const void* b, const float* h0, void* out,
                 int B, int L, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  lru_scan_kernel<Reverse, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(out), L, R, h0 != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h0 may be null. Returns a
// cudaError_t (0 = launched).
extern "C" int lru_scan_launch(const void* a, const void* b, const void* h0,
                               void* out, int dtype, int B, int L, int R,
                               void* stream) {
  if (B < 1 || B > 65535 || L < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  if (dtype == 0)
    return launch_typed<false, float>(a, b, h, out, B, L, R, st);
  if (dtype == 1)
    return launch_typed<false, __nv_bfloat16>(a, b, h, out, B, L, R, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's reverse recurrence, f32: lam (B, L, R) from a and the
// upstream gradient g, both (B, L, R) f32. Returns a cudaError_t.
extern "C" int lru_scan_reverse_launch(const void* a, const void* g,
                                       void* lam, int B, int L, int R,
                                       void* stream) {
  if (B < 1 || B > 65535 || L < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_typed<true, float>(a, g, nullptr, lam, B, L, R,
                                   static_cast<cudaStream_t>(stream));
}
