// Mamba-2 intra-chunk SSD (state-space duality) for Hopper (sm_90a),
// f32 and bf16.
//
// Replaces src/repro/kernels/ssd_chunk.py::ssd_chunk (the TPU Pallas
// kernel: grid (B*H, L/Q), one (Q x Q) decay-masked score matrix per
// cell held in VMEM, both contractions on the MXU).
//
// Contract (that of the Pallas kernel and of the plain PyTorch version
// repro_torch/kernels/ssd_chunk.py::ssd_chunk_torch):
//   xdt (B, L, H, P), loga (B, L, H), Bm/Cm (B, L, H, N), all of one
//   type T (float or bf16), read through element strides (the last axis
//   of xdt, Bm and Cm has stride 1; any other stride may be anything,
//   0 included, so heads broadcast from one group cost no copy);
//   y (B, L, H, P) contiguous, of type T. The sequence is cut into
//   chunks of Q positions (the last one may be shorter). Inside a chunk,
//   for each (b, h):
//     z_i = loga_0 + ... + loga_i                    (f32, in this order)
//     y_i = sum_{j <= i} (C_i . B_j) * exp(z_i - z_j) * x_j
//   with every product and sum in f32 and y rounded to T once. z is the
//   sequential cumsum, the order torch.cumsum takes along a dimension
//   that is not the innermost, and the decay is a difference of two
//   cumsums (never a segment sum, which rounds differently). An entry
//   with j > i is 0 by a select, never by a multiply with a mask: there
//   z_i - z_j can be large and positive, exp of it inf, and inf * 0 NaN.
//
// Bound: at the mamba2-1.3b prefill shape (B 4, L 2048, H 64, P 64,
// N 128, Q 256, f32 operands as ssd_scan passes them) the causal half of
// the work is 2 * (N + P) * Q(Q+1)/2 FLOP per (b, h, chunk), 2.6e10 FLOP
// a call, against 279 MB of inputs and output, so the f32 rate bounds it
// (0.39 ms at 67 TFLOP/s). This first version is simple and right: f32
// on the CUDA cores, no tensor cores, so it runs far from that bound.
//
// Design. One block of 8 warps per (b*h, chunk, 64 query rows)
// (blockIdx.x, .y, .z). The chunk's loga up to the block's last row is
// staged in shared memory and one thread takes its cumsum; the block's
// 64 C rows are staged once as f32. Key tiles of 32 rows of B and x are
// then staged in turn, up to the block's last row: tiles wholly above the
// diagonal are never visited. Each warp owns 8 query rows; in a tile,
// lane l scores key l against the warp's rows (a dot product over N from
// shared memory, B rows padded by 4 floats so the lanes' 16-byte reads
// hit distinct banks), weighs it by the decay, and the weights are
// broadcast by shuffles into the accumulator, whose columns l, l+32, ...
// of P the lane keeps in registers (NJ = ceil(P/32)). The ragged edges
// (a short last chunk, rows past it) are masked here, not padded.
// Above 48 KB of shared memory the launch raises the kernel's dynamic
// limit first; every CUDA error is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                      // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kKeys = 32;                      // keys per tile, one per lane
constexpr int kMaxChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

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

struct Strides {             // element strides of the (b, l, h) axes
  long long b, l, h;
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ loga,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 T* __restrict__ y, int L, int H, int P, int N, int Q,
                 Strides xs, Strides ls, Strides bs, Strides cs) {
  extern __shared__ float4 smem4[];
  const int n4 = (N + 3) / 4;                  // float4s of a B/C row
  const int ldn = 4 * n4 + 4;                  // padded row, floats
  float* zs = reinterpret_cast<float*>(smem4); // kMaxChunk
  float* Cs = zs + kMaxChunk;                  // kRows x ldn
  float* Bs = Cs + kRows * ldn;                // kKeys x ldn
  float* Xs = Bs + kKeys * ldn;                // kKeys x P

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int l0 = blockIdx.y * Q;
  const int qc = min(Q, L - l0);               // this chunk's length
  const int i0 = blockIdx.z * kRows;
  if (i0 >= qc) return;                        // the whole block: uniform
  const int n_keys = min(qc, i0 + kRows);      // chunk positions needed
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* xb = x + b * xs.b + h * xs.h + static_cast<long long>(l0) * xs.l;
  const T* lb = loga + b * ls.b + h * ls.h + static_cast<long long>(l0) * ls.l;
  const T* bb = bm + b * bs.b + h * bs.h + static_cast<long long>(l0) * bs.l;
  const T* cb = cm + b * cs.b + h * cs.h + static_cast<long long>(l0) * cs.l;

  // loga of the chunk's first n_keys positions, then their cumsum by
  // one thread in order (f32).
  for (int s = tid; s < n_keys; s += kThreads) zs[s] = to_f32(lb[s * ls.l]);
  // The block's C rows as f32, zero past the chunk and in the padding.
  for (int idx = tid; idx < kRows * 4 * n4; idx += kThreads) {
    const int rr = idx / (4 * n4), n = idx - rr * (4 * n4);
    const int i = i0 + rr;
    Cs[rr * ldn + n] = (i < qc && n < N) ? to_f32(cb[i * cs.l + n]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int s = 0; s < n_keys; ++s) {
      run += zs[s];
      zs[s] = run;
    }
  }

  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int wrow0 = i0 + warp * kRowsPerWarp;  // the warp's first row
  const float4* C4 = reinterpret_cast<const float4*>(
      Cs + warp * kRowsPerWarp * ldn);
  for (int kt = 0; kt < n_keys; kt += kKeys) {
    __syncthreads();          // z ready; the previous tile's readers done
    for (int idx = tid; idx < kKeys * 4 * n4; idx += kThreads) {
      const int kk = idx / (4 * n4), n = idx - kk * (4 * n4);
      const int s = kt + kk;
      Bs[kk * ldn + n] = (s < n_keys && n < N) ? to_f32(bb[s * bs.l + n])
                                               : 0.f;
    }
    for (int idx = tid; idx < kKeys * P; idx += kThreads) {
      const int kk = idx / P, p = idx - kk * P;
      const int s = kt + kk;
      Xs[idx] = s < n_keys ? to_f32(xb[s * xs.l + p]) : 0.f;
    }
    __syncthreads();
    if (kt > wrow0 + kRowsPerWarp - 1) continue;   // the warp's rows < kt

    // Score of key kt + lane against the warp's rows, f32.
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const float4* B4 = reinterpret_cast<const float4*>(Bs + lane * ldn);
    for (int d = 0; d < n4; ++d) {
      const float4 bv = B4[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 cv = C4[i * (ldn / 4) + d];
        sc[i] = fmaf(cv.x, bv.x, sc[i]);
        sc[i] = fmaf(cv.y, bv.y, sc[i]);
        sc[i] = fmaf(cv.z, bv.z, sc[i]);
        sc[i] = fmaf(cv.w, bv.w, sc[i]);
      }
    }
    // Weight w_ij = (C_i . B_j) * exp(z_i - z_j) where j <= i, else 0.
    const int key = kt + lane;
    const float zk = zs[min(key, n_keys - 1)];
    float w[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = wrow0 + i;
      const bool ok = key <= row && row < qc;
      w[i] = ok ? sc[i] * expf(zs[min(row, n_keys - 1)] - zk) : 0.f;
    }
    // acc += w . x over the tile's keys; lane owns columns lane + 32 j.
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float xv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        xv[j] = c < P ? Xs[kk * P + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float wk = __shfl_sync(kFull, w[i], kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(wk, xv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = wrow0 + i;
    if (row >= qc) break;
    T* dst = y + ((static_cast<size_t>(b) * L + l0 + row) * H + h) * P;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < P) dst[c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
int launch_typed(const void* x, const void* loga, const void* bm,
                 const void* cm, void* y, int B, int L, int H, int P, int N,
                 int Q, Strides xs, Strides ls, Strides bs, Strides cs,
                 cudaStream_t stream) {
  const int ldn = 4 * ((N + 3) / 4) + 4;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kMaxChunk) +
                       static_cast<size_t>(kRows + kKeys) * ldn +
                       static_cast<size_t>(kKeys) * P);
  auto kernel = ssd_chunk_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (L + Q - 1) / Q, (Q + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(loga),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), L, H, P, N, Q, xs, ls, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const void* loga, const void* bm, const void* cm,
             void* y, int B, int L, int H, int P, int N, int Q, Strides xs,
             Strides ls, Strides bs, Strides cs, cudaStream_t stream) {
#define SSD_CASE(NJ)                                                       \
  case NJ:                                                                 \
    return launch_typed<T, NJ>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs,   \
                               ls, bs, cs, stream);
  switch ((P + 31) / 32) {
    SSD_CASE(1) SSD_CASE(2) SSD_CASE(3) SSD_CASE(4)
    SSD_CASE(5) SSD_CASE(6) SSD_CASE(7) SSD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the
// (b, l, h) axes of xdt, loga, Bm and Cm in that order. Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_chunk_launch(const void* x, const void* loga,
                                const void* bm, const void* cm, void* y,
                                int dtype, int B, int L, int H, int P, int N,
                                int Q, const long long* strides,
                                void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || P > 256 || N < 1 || N > 256 ||
      Q < 1 || Q > kMaxChunk || static_cast<long long>(B) * H > 2147483647LL ||
      (L + Q - 1) / Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides ls{strides[3], strides[4], strides[5]};
  const Strides bs{strides[6], strides[7], strides[8]};
  const Strides cs{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs, ls, bs,
                           cs, st);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs,
                                   ls, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
