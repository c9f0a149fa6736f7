// Forward GQA flash attention for Hopper (sm_90a), f32 and bf16.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the
// TPU Pallas kernel: grid (B*KV, Sq/128, Skv/128) with the KV axis a
// sequential grid dimension carrying the online-softmax state in VMEM
// scratch, the G = H/KV query heads of a group riding in the q block).
//
// Contract (that of the Pallas kernel and of the plain PyTorch version
// repro_torch/kernels/flash_attention.py::flash_attention_torch):
//   q (B, Sq, H, hd), k/v (B, Skv, KV, hd), o (B, Sq, H, hd), all of
//   one type T (float or bf16), contiguous. Query i sits at absolute
//   position q_offset + i (the wrapper passes q_offset = Skv - Sq: the
//   queries are the last Sq positions), key j at j. Key j is attended by query i iff
//   j < Skv, (!causal or j <= pos_i) and (window <= 0 or
//   j > pos_i - window). Scores s = (q.k) * sm_scale in f32 (bf16
//   products are exact in f32), then cap * tanh(s / cap) when
//   softcap > 0. Online softmax in f32: m' = max(m, max_j s_j),
//   alpha = exp(m - m'), p_j = attended ? exp(s_j - m') : 0 (a masked
//   probability is 0, never exp of a large negative number: a row
//   whose tile is wholly masked keeps m = -1e30, where exp(s - m) would
//   be 1), l' = l * alpha + sum_j p_j, acc' = acc * alpha +
//   sum_j round_T(p_j) v_j (p is rounded to v's type before the PV
//   product, as the Pallas kernel casts it). o = acc / max(l, 1e-30),
//   rounded to T.
//
// Bound: at the serving prefill shape (B 4, Sq = Skv 2048, H 32, KV 8,
// hd 160, causal, bf16) the work is 4*B*H*hd*(Skv*(Skv+1)/2) = 1.72e11
// FLOP against 210 MB of q/k/v/o, so the tensor cores' rate bounds it
// (0.174 ms at 989 TFLOP/s). This first version is simple and right:
// it computes on the CUDA cores in f32 (no mma/wgmma, no TMA), so it
// runs far from that bound; making it fast is later work.
//
// Design. A row is one (query, g) pair; rows of one (batch, KV head)
// are flattened as r = query * G + g, so the G heads of a group share
// every K/V tile, as in the Pallas kernel. One block of 8 warps takes
// 64 consecutive rows of one (batch, KV head) (blockIdx.y) and loops
// over 32-key K/V tiles staged in shared memory as f32; its Q rows are
// staged once. Each warp owns 8 rows; in a tile, lane l scores key l
// against the warp's 8 rows, so the row max and row sum are warp
// shuffles, and the lane keeps the accumulator columns l, l+32, ... of
// its warp's rows in registers (NJ = ceil(hd/32) columns). The K tile
// rows are padded to hd+4 floats so the lanes' 16-byte reads hit
// distinct banks. Only tiles that hold a key some row of the block
// attends are visited: tiles wholly above the causal diagonal or
// wholly outside the window contribute exactly nothing (alpha = 1,
// p = 0), so skipping them changes no bit. The ragged edges (rows past
// Sq*G, keys past Skv) are masked here, not padded. hd must be a
// multiple of 8 (16-byte loads) and at most 256; the entry point
// returns cudaErrorInvalidValue otherwise. Above 48 KB of shared
// memory (hd > 88) the launch raises the kernel's dynamic
// shared-memory limit first; every CUDA error is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                      // rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kKeys = 32;                      // keys per tile, one per lane
constexpr float kNegInf = -1e30f;              // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

// Eight consecutive elements (16 or 32 bytes, aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {            // little endian: low half first
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T (round to nearest even) and widened back to f32.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int hd, int q_offset, int causal, int window,
                 float softcap, float sm_scale) {
  extern __shared__ float4 smem4[];
  const int ldk = hd + 4;
  float* Qs = reinterpret_cast<float*>(smem4);   // kRows x hd
  float* Ks = Qs + kRows * hd;                    // kKeys x ldk
  float* Vs = Ks + kKeys * ldk;                   // kKeys x hd

  const int G = H / KV;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int n_rows = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd8 = hd >> 3;
  const T zero_t = from_f32<T>(0.f);

  // Stage the block's Q rows as f32 (rows past the end as zeros).
  for (int idx = tid; idx < kRows * hd8; idx += kThreads) {
    const int rr = idx / hd8, seg = idx - rr * hd8;
    const int r = r0 + rr;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n_rows) {
      const int qi = r / G, g = r - qi * G;
      load8(q + ((static_cast<size_t>(b) * Sq + qi) * H +
                 static_cast<size_t>(kvh) * G + g) * hd + seg * 8, x);
    }
    store8(Qs + rr * hd + seg * 8, x);
  }

  // Absolute positions of the warp's rows (a row past the end takes the
  // last row's position; its output is never stored).
  const int wr0 = r0 + warp * kRowsPerWarp;
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    qpos[i] = min(wr0 + i, n_rows - 1) / G + q_offset;

  // Keys some row of the block attends: [k_begin, k_end).
  const int pos_first = r0 / G + q_offset;
  const int pos_last = (min(r0 + kRows, n_rows) - 1) / G + q_offset;
  const int k_end = causal ? min(Skv, pos_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const float4* Q4 = reinterpret_cast<const float4*>(
      Qs + warp * kRowsPerWarp * hd);
  const int hd4 = hd >> 2;
  for (int kt = (k_begin / kKeys) * kKeys; kt < k_end; kt += kKeys) {
    __syncthreads();          // Q staged; the previous tile's readers done
    for (int idx = tid; idx < kKeys * hd8; idx += kThreads) {
      const int kk = idx / hd8, seg = idx - kk * hd8;
      const int s = kt + kk;
      float xk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (s < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + s) * KV + kvh) *
                               hd + seg * 8;
        load8(k + off, xk);
        load8(v + off, xv);
      }
      store8(Ks + kk * ldk + seg * 8, xk);
      store8(Vs + kk * hd + seg * 8, xv);
    }
    __syncthreads();

    // Scores of key kt + lane against the warp's rows, f32.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float4* K4 = reinterpret_cast<const float4*>(Ks + lane * ldk);
    for (int d4 = 0; d4 < hd4; ++d4) {
      const float4 kv4 = K4[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = Q4[i * hd4 + d4];
        s[i] = fmaf(qv.x, kv4.x, s[i]);
        s[i] = fmaf(qv.y, kv4.y, s[i]);
        s[i] = fmaf(qv.z, kv4.z, s[i]);
        s[i] = fmaf(qv.w, kv4.w, s[i]);
      }
    }

    // Online softmax, one row at a time across the warp.
    const int key = kt + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float si = s[i] * sm_scale;
      if (softcap > 0.f) si = softcap * tanhf(si / softcap);
      const bool ok = key < Skv && (!causal || key <= qpos[i]) &&
                      (window <= 0 || key > qpos[i] - window);
      si = ok ? si : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      const float pi = ok ? expf(si - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pi);
      m[i] = m_new;
      p[i] = round_to(pi, zero_t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    // acc += p . V over the tile's keys; lane owns columns lane + 32 j.
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < hd ? Vs[kk * hd + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pk = __shfl_sync(kFull, p[i], kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pk, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = wr0 + i;
    if (r >= n_rows) break;
    const int qi = r / G, g = r - qi * G;
    T* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H +
                  static_cast<size_t>(kvh) * G + g) * hd;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) dst[c] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Skv, int H, int KV, int hd, int q_offset,
                 int causal, int window, float softcap, float sm_scale,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * hd +
                       static_cast<size_t>(kKeys) * (hd + 4) +
                       static_cast<size_t>(kKeys) * hd);
  auto kernel = flash_fwd_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int G = H / KV;
  const dim3 grid((Sq * G + kRows - 1) / kRows, B * KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, hd,
      q_offset, causal, window, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int KV, int hd, int q_offset,
              int causal, int window, float softcap, float sm_scale,
              cudaStream_t stream) {
#define FLASH_CASE(NJ)                                                      \
  case NJ:                                                                  \
    return launch_typed<T, NJ>(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset, \
                               causal, window, softcap, sm_scale, stream);
  switch ((hd + 31) / 32) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int Sq, int Skv, int H, int KV, int hd,
                                      int q_offset, int causal, int window,
                                      float softcap, float sm_scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Skv < 0 || KV < 1 || H % KV != 0 || hd < 8 ||
      hd > 256 || hd % 8 != 0 || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset,
                            causal, window, softcap, sm_scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd,
                                    q_offset, causal, window, softcap,
                                    sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
