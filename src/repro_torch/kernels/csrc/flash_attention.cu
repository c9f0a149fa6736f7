// Forward GQA flash attention for Hopper (sm_90a): bf16 on the tensor
// cores (wgmma, K/V through TMA), f32 on the CUDA cores.
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
// (0.174 ms at 989 TFLOP/s).
//
// Two kernels, chosen by type in the entry point (a documented split,
// not a fallback: each type has one kernel, and a refused launch is
// returned as an error):
//
// * bf16, flash_fwd_kernel_wgmma: both products on the tensor cores.
//   A row is one (query, g) pair; rows of one (batch, KV head) are
//   flattened as r = query * G + g, so the G heads of a group share
//   every K/V tile. A block of three warpgroups owns 128 rows: two
//   consumer warpgroups of 64 rows (one wgmma M tile each) and one
//   producer warpgroup, of which one thread issues the TMA loads and
//   the rest leave at once (setmaxnreg gives the consumers 240
//   registers a thread, the producer 24). The block's Q rows are staged
//   once by the consumers with 16-byte loads (with G = 12, 64 rows are
//   no TMA box of q). K and V tiles of Bk keys (128 for hd <= 160, 64
//   above) come by TMA through two rings, one for K and one for V, of 3
//   stages where they fit in shared memory (2 at hd 129-160 and above
//   224), each stage with a full and an empty mbarrier, so a K tile is
//   refilled as soon as S is done with it. Their 4-d tensor maps
//   {hd, KV, Skv, B} make TMA zero-fill keys past Skv and columns past
//   hd. Every operand lives in shared memory as
//   32-column atoms of 64 bytes a row under the 64-byte swizzle, so hd
//   pads to a multiple of 32 (160 = 5 atoms; at most 24 zero columns,
//   which add exactly 0). S = Q K^T is wgmma m64nBk k16 with both
//   operands in shared memory (K-major), over hd in steps of 16. The
//   online softmax runs on S's accumulator fragment: a thread holds 2
//   rows, a row's 4 threads reduce its max with two shuffles, the scale
//   sm_scale * log2(e) is folded into one multiply before exp2f, and the
//   mask is applied only on tiles that cross the causal diagonal, the
//   window's lower edge or Skv. p rounded to bf16 is the A operand of
//   O += P V in registers (the accumulator fragment of S is the A
//   fragment of P); V is the B operand read transposed from shared
//   memory, N = hd padded to the atom. A warpgroup pipelines its tiles
//   as FlashAttention-3 does: S of tile t and P V of tile t - 1 are
//   issued together, and the softmax of tile t runs while P V runs.
//   Registers at hd 256: O 128 f32, S 32, P 16. Only key tiles some row
//   of the block attends are visited; the grid runs the heaviest row
//   tiles (the last queries) first.
//
// * f32, flash_fwd_kernel: on the CUDA cores in f32 (wgmma has no f32
//   operands, and TF32 would not meet the f32 contract's 2e-5). One
//   block of 8 warps takes 64 consecutive rows of one (batch, KV head)
//   (blockIdx.y) and loops over 32-key K/V tiles staged in shared
//   memory; its Q rows are staged once. Each warp owns 8 rows; in a
//   tile, lane l scores key l against the warp's 8 rows, so the row max
//   and row sum are warp shuffles, and the lane keeps the accumulator
//   columns l, l+32, ... of its warp's rows in registers (NJ =
//   ceil(hd/32) columns). The K tile rows are padded to hd+4 floats so
//   the lanes' 16-byte reads hit distinct banks. Tiles wholly above the
//   causal diagonal or wholly outside the window contribute exactly
//   nothing (alpha = 1, p = 0) and are skipped. The ragged edges (rows
//   past Sq*G, keys past Skv) are masked here, not padded.
//
// hd must be a multiple of 8 (16-byte loads, TMA strides) and at most
// 256; the entry point returns cudaErrorInvalidValue otherwise. The
// launches raise the kernels' dynamic shared-memory limit first; every
// CUDA error is returned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;              // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// f32: the CUDA-core kernel.

constexpr int kRows = 64;                      // rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kKeys = 32;                      // keys per tile, one per lane

// Eight consecutive floats (32 bytes, aligned).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
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

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int H, int KV, int hd, int q_offset, int causal,
                 int window, float softcap, float sm_scale) {
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

  // Stage the block's Q rows (rows past the end as zeros).
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

    // Scores of key kt + lane against the warp's rows.
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
      p[i] = pi;
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
    float* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H +
                      static_cast<size_t>(kvh) * G + g) * hd;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) dst[c] = acc[i][j] / den;
    }
  }
}

template <int NJ>
int launch_f32_nj(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int H, int KV, int hd, int q_offset,
                  int causal, int window, float softcap, float sm_scale,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * hd +
                       static_cast<size_t>(kKeys) * (hd + 4) +
                       static_cast<size_t>(kKeys) * hd);
  auto kernel = flash_fwd_kernel<NJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int G = H / KV;
  const dim3 grid((Sq * G + kRows - 1) / kRows, B * KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      hd, q_offset, causal, window, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int hd, int q_offset,
               int causal, int window, float softcap, float sm_scale,
               cudaStream_t stream) {
#define FLASH_CASE(NJ)                                                       \
  case NJ:                                                                   \
    return launch_f32_nj<NJ>(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset,    \
                             causal, window, softcap, sm_scale, stream);
  switch ((hd + 31) / 32) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

// ---------------------------------------------------------------------
// bf16: the tensor-core kernel. PTX wrappers first.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-d tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// A wgmma operand descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 64-byte swizzle (2 in bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers in place around wgmma: the compiler may not move their
// reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// 2^x on the special-function unit (inputs below -126 give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);   // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&x);
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16, written out for each N
// the kernel uses. _ss: A and B from shared memory, both K-major (Q and
// K). _rs: A from registers (P), B from shared memory transposed (V,
// N-major).

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n224(float (&d)[112],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "S tiles are 64 or 128 keys");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db);
  else wgmma_ss_n128(d, da, db);
}

template <int NA>
__device__ __forceinline__ void wgmma_rs(float (&d)[16 * NA],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NA == 1) wgmma_rs_n32(d, a, db);
  else if constexpr (NA == 2) wgmma_rs_n64(d, a, db);
  else if constexpr (NA == 3) wgmma_rs_n96(d, a, db);
  else if constexpr (NA == 4) wgmma_rs_n128(d, a, db);
  else if constexpr (NA == 5) wgmma_rs_n160(d, a, db);
  else if constexpr (NA == 6) wgmma_rs_n192(d, a, db);
  else if constexpr (NA == 7) wgmma_rs_n224(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

constexpr int kAtom = 32;            // bf16 columns of one swizzle atom
constexpr int kAtomRow = 64;         // bytes of one atom row (64-byte swizzle)
constexpr int kWgRows = 64;          // rows of a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBlockRows = kConsumers * kWgRows;
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = (kConsumers + 1) * kWgThreads;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan for hd padded to NA atoms: Q as [warpgroup][atom]
// [64 rows][64 B], then the stages of the K and V rings, each tile as
// [atom][Bk keys][64 B]: 3 stages where they fit in the 227 KB a block
// may use, else 2. Bk = 128 up to hd 160 (S's wgmma then reads Q once
// for 128 keys), 64 above, where O's hd/2 f32 registers a thread leave
// no room for a 128-key S. Every piece starts on a multiple of 1024
// bytes, so the swizzle (a function of address bits 4-8) is the same for
// TMA, the Q stores and wgmma.
template <int NA>
struct WgmmaTile {
  static constexpr int kBk = NA <= 5 ? 128 : 64;
  static constexpr int kQBytes = kBlockRows * NA * kAtomRow;
  static constexpr int kKVBytes = kBk * NA * kAtomRow;      // one K or V tile
  static constexpr int kLimit = 232448 - 1024 - 64;   // less alignment, barriers
  static constexpr int kStages =
      kQBytes + 3 * 2 * kKVBytes <= kLimit ? 3 : 2;
  static constexpr int kSmem = kQBytes + kStages * 2 * kKVBytes + 1024;
  static_assert(kQBytes + kStages * 2 * kKVBytes <= kLimit,
                "over the shared memory");
};

template <int NA>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                       int KV, int hd, int q_offset, int causal, int window,
                       float softcap, float sm_scale, int n_tiles) {
  using Tile = WgmmaTile<NA>;
  constexpr int Bk = Tile::kBk;
  constexpr int kStages = Tile::kStages;
  extern __shared__ uint8_t smem_raw[];
  // K and V have rings of their own, so a K tile is released as soon
  // as S is done with it: full_k[s], full_v[s], empty_k[s], empty_v[s].
  __shared__ uint64_t bars[4 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Tile::kQBytes;
  const uint32_t full_k = smem_u32(&bars[0]);
  const uint32_t full_v = smem_u32(&bars[kStages]);
  const uint32_t empty_k = smem_u32(&bars[2 * kStages]);
  const uint32_t empty_v = smem_u32(&bars[3 * kStages]);

  // Heaviest row tiles first: block ids run over (tile, b * KV + head)
  // with the tile descending.
  const int n_bh = gridDim.x / n_tiles;
  const int bh = blockIdx.x % n_bh;
  const int tile = n_tiles - 1 - blockIdx.x / n_bh;
  const int b = bh / KV, kvh = bh % KV;
  const int G = H / KV;
  const int n_rows = Sq * G;
  const int r0 = tile * kBlockRows;

  // Key tiles some row of the block attends.
  const int pos_first = r0 / G + q_offset;
  const int pos_last = (min(r0 + kBlockRows, n_rows) - 1) / G + q_offset;
  const int k_end = causal ? min(Skv, pos_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int kt0 = (k_begin / Bk) * Bk;
  const int n_kt = k_end > kt0 ? (k_end - kt0 + Bk - 1) / Bk : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);                // the producer's arrival
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers * 4);  // one per consumer warp
      mbar_init(empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / kWgThreads;
  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * kWgThreads) {
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        const uint32_t ks = kv_s + 2 * s * Tile::kKVBytes;
        const uint32_t vs = ks + Tile::kKVBytes;
        const int kt = kt0 + it * Bk;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, Tile::kKVBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(ks + a * Bk * kAtomRow, &k_map, full_k + 8 * s,
                      a * kAtom, kvh, kt, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, Tile::kKVBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(vs + a * Bk * kAtomRow, &v_map, full_v + 8 * s,
                      a * kAtom, kvh, kt, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = tid % kWgThreads;
    const int warp = wtid / 32, lane = tid % 32;
    const int wr0 = r0 + wg * kWgRows;
    const uint32_t q_wg = q_s + wg * (NA * kWgRows * kAtomRow);

    // Stage the warpgroup's 64 Q rows as 64-byte-swizzled atoms: the
    // 16-byte chunk c of row r of an atom sits at chunk c ^ ((r/2) % 4).
    for (int idx = wtid; idx < kWgRows * NA * 4; idx += kWgThreads) {
      const int rr = idx / (NA * 4), rem = idx % (NA * 4);
      const int a = rem / 4, ch = rem % 4;
      const int r = wr0 + rr, col = a * kAtom + ch * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows && col < hd) {
        const int qi = r / G, g = r - qi * G;
        x = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * Sq + qi) * H +
                 static_cast<size_t>(kvh) * G + g) * hd + col);
      }
      st_shared_16(q_wg + a * kWgRows * kAtomRow + rr * kAtomRow +
                       ((ch ^ ((rr >> 1) & 3)) << 4), x);
    }
    // the generic-proxy stores must be visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "r"(kWgThreads)
                 : "memory");

    // This thread's two rows of the accumulator fragment: h = 0 is row
    // warp*16 + lane/4 of the warpgroup, h = 1 eight rows below.
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qpos[h] = min(wr0 + warp * 16 + lane / 4 + 8 * h, n_rows - 1) / G +
                q_offset;
    const int wg_pos_first = min(wr0, n_rows - 1) / G + q_offset;
    const int wg_pos_last = (min(wr0 + kWgRows, n_rows) - 1) / G + q_offset;
    const float scale_log2 = sm_scale * kLog2e;

    float acc[16 * NA];
#pragma unroll
    for (int j = 0; j < 16 * NA; ++j) acc[j] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[Bk / 2];              // S of one tile, then its p in place
    uint32_t pa[Bk / 16][4];       // p rounded to bf16: P V's A fragment

    // Issue S = Q K^T of the tile in stage s, over hd in steps of 16
    // (two steps an atom), as one wgmma group.
    auto issue_s = [&](int s) {
      const uint32_t ks = kv_s + 2 * s * Tile::kKVBytes;
#pragma unroll
      for (int j = 0; j < Bk / 2; ++j) sc[j] = 0.f;
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * NA; ++kk) {
        const uint32_t step = (kk & 1) * 32;   // 16 columns
        wgmma_ss<Bk>(sc,
                     smem_desc(q_wg + (kk >> 1) * kWgRows * kAtomRow + step,
                               16, 8 * kAtomRow),
                     smem_desc(ks + (kk >> 1) * Bk * kAtomRow + step, 16,
                               8 * kAtomRow));
      }
      wgmma_commit();
    };
    // Issue O += P V with the V tile in stage s, 16 keys a step, V read
    // transposed, as one wgmma group.
    auto issue_pv = [&](int s) {
      const uint32_t vs = kv_s + (2 * s + 1) * Tile::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < Bk / 16; ++kk)
        wgmma_rs<NA>(acc, pa[kk],
                     smem_desc(vs + kk * 16 * kAtomRow, Bk * kAtomRow,
                               8 * kAtomRow));
      wgmma_commit();
    };
    // The online-softmax step on the tile of keys from kt: sc holds S in,
    // p out (a masked p is 0 by a select); m and l advance and alpha is
    // the factor the accumulator must take.
    auto softmax_step = [&](int kt) {
      // Scores in log2 units; sc[j] is row h = (j >> 1) & 1, key
      // kt + (j >> 2) * 8 + 2 * (lane % 4) + (j & 1).
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < Bk / 2; ++j)
          sc[j] = softcap * tanhf(sc[j] * sm_scale / softcap) * kLog2e;
      } else {
#pragma unroll
        for (int j = 0; j < Bk / 2; ++j) sc[j] *= scale_log2;
      }
      // Only tiles that cross Skv, the causal diagonal or the window's
      // lower edge for some row of the warpgroup are masked.
      const bool masked = kt + Bk > Skv ||
                          (causal && kt + Bk - 1 > wg_pos_first) ||
                          (window > 0 && kt <= wg_pos_last - window);
      uint64_t attended = ~0ull;
      if (masked) {
#pragma unroll
        for (int j = 0; j < Bk / 2; ++j) {
          const int key = kt + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
          const int pos = qpos[(j >> 1) & 1];
          const bool ok = key < Skv && (!causal || key <= pos) &&
                          (window <= 0 || key > pos - window);
          if (!ok) {
            attended &= ~(1ull << j);
            sc[j] = kNegInf;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 2 * h; j < Bk / 2; j += 4)
          mx = fmaxf(mx, fmaxf(sc[j], sc[j + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      if (!masked) {
#pragma unroll
        for (int j = 0; j < Bk / 2; ++j) {
          const int h = (j >> 1) & 1;
          sc[j] = ex2(sc[j] - m[h]);
          l[h] += sc[j];           // l sums p unrounded
        }
        return;
      }
#pragma unroll
      for (int j = 0; j < Bk / 2; ++j) {
        const int h = (j >> 1) & 1;
        sc[j] = (attended >> j) & 1ull ? ex2(sc[j] - m[h]) : 0.f;
        l[h] += sc[j];             // l sums p unrounded
      }
    };
    // Rescale the accumulator by alpha and round p to bf16 into the A
    // fragment (the accumulator entries of keys 16 kk .. 16 kk + 15 are
    // sc[8 kk .. 8 kk + 7]).
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < 16 * NA; ++j) acc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < Bk / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    // Release stage s of a ring once this warp is done with it.
    auto release = [&](uint32_t empty, int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    };
    // Software pipeline, as in FlashAttention-3: while the softmax of
    // tile t runs on the CUDA cores, the tensor cores run P V of tile
    // t - 1.
    if (n_kt > 0) {
      mbar_wait(full_k, 0);
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k, 0);
      softmax_step(kt0);
      rescale_and_pack();
    }
    for (int it = 1; it < n_kt; ++it) {
      const int s = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(full_k + 8 * s, (it / kStages) & 1);
      issue_s(s);
      mbar_wait(full_v + 8 * prev, ((it - 1) / kStages) & 1);
      issue_pv(prev);
      wgmma_wait<1>();             // S of tile it is done
      fence_regs(sc);
      release(empty_k, s);
      softmax_step(kt0 + it * Bk);
      wgmma_wait<0>();             // P V of tile it - 1 is done
      fence_regs(acc);
      fence_regs(pa);
      release(empty_v, prev);
      rescale_and_pack();
    }
    if (n_kt > 0) {
      const int last = (n_kt - 1) % kStages;
      mbar_wait(full_v + 8 * last, ((n_kt - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(last);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // o = acc / max(l, 1e-30): l summed over the row's 4 threads.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
      const int r = wr0 + warp * 16 + lane / 4 + 8 * h;
      if (r >= n_rows) continue;
      const int qi = r / G, g = r - qi * G;
      __nv_bfloat16* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H +
                                static_cast<size_t>(kvh) * G + g) * hd;
      const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int i = 0; i < 4 * NA; ++i) {
        const int col = i * 8 + 2 * (lane & 3);
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * h] / den,
                                    acc[4 * i + 2 * h + 1] / den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// k or v (B, Skv, KV, hd) as a 4-d map {hd, KV, Skv, B}, boxes of one
// atom by Bk keys, 64-byte swizzle; keys past Skv and columns past hd
// read as zeros.
int kv_map(CUtensorMap* map, const void* ptr, int B, int Skv, int KV, int hd,
           int Bk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(Skv),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * KV, row * KV * Skv};  // bytes
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(Bk), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NA>
int launch_bf16_na(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KV, int hd,
                   int q_offset, int causal, int window, float softcap,
                   float sm_scale, cudaStream_t stream) {
  using Tile = WgmmaTile<NA>;
  CUtensorMap k_map = {}, v_map = {};
  if (Skv > 0) {          // with no keys the maps are never read
    int err = kv_map(&k_map, k, B, Skv, KV, hd, Tile::kBk);
    if (err == 0) err = kv_map(&v_map, v, B, Skv, KV, hd, Tile::kBk);
    if (err != 0) return err;
  }
  auto kernel = flash_fwd_kernel_wgmma<NA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (Sq * (H / KV) + kBlockRows - 1) / kBlockRows;
  kernel<<<n_tiles * B * KV, kWgmmaThreads, Tile::kSmem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV, hd, q_offset, causal,
      window, softcap, sm_scale, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int KV, int hd, int q_offset,
                int causal, int window, float softcap, float sm_scale,
                cudaStream_t stream) {
#define FLASH_CASE(NA)                                                       \
  case NA:                                                                   \
    return launch_bf16_na<NA>(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset,   \
                              causal, window, softcap, sm_scale, stream);
  switch ((hd + kAtom - 1) / kAtom) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel). Returns a cudaError_t (0 = launched).
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
    return launch_f32(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset, causal,
                      window, softcap, sm_scale, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, o, B, Sq, Skv, H, KV, hd, q_offset, causal,
                       window, softcap, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
