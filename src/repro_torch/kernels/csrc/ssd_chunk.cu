// Mamba-2 intra-chunk SSD (state-space duality) for Hopper (sm_90a),
// f32 and bf16, on the tensor cores at f32 accuracy (3xTF32 wgmma).
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
//   with y rounded to T once. z is the sequential cumsum, and the decay
//   is a difference of two cumsums (never a segment sum). An entry with
//   j > i is 0 by a select, never by a multiply with a mask: there
//   z_i - z_j can be large and positive, exp of it inf, and inf * 0 NaN.
//
// Accuracy: both products run on the tensor cores as 3xTF32. A float
// v is split into hi = tf32(v) (cvt.rna) and lo = tf32(v - hi); a
// product a.b is taken as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, which keeps
// about 21 bits of each operand (the dropped a_lo.b_lo is 2^-22 of a.b),
// with f32 accumulation. One TF32 pass keeps 11 bits and misses the f32
// tolerance of 1e-4 (tests/test_torch_ssd_chunk.py shows both on the
// CPU). The sums run in another order than the plain version's, so the
// kernel agrees with it to that tolerance (1e-4 f32, 5e-2 bf16), not
// bit for bit. A bf16 input is exact in TF32 (lo = 0), so for bf16 only
// the f32 decay weights W are split: S takes one product, Y two.
//
// Bound: at the mamba2-1.3b prefill shape (B 4, L 2048, H 64, P 64,
// N 128, Q 256, f32 operands as ssd_scan passes them) the causal half of
// the work is 2 * (N + P) * Q(Q+1)/2 FLOP per (b, h, chunk), 2.59e10
// FLOP a call, against 279 MB of inputs and output. On this route the
// three TF32 products take 3 x 2.59e10 / 495 TFLOP/s = 0.157 ms, above
// the bytes' 0.083 ms (the f32 CUDA-core route's bound was 0.386 ms).
//
// Design. One block per (b*h, chunk, 128 query rows, 64 columns of P)
// (blockIdx.x, .y, .z): two warpgroups, each owning 64 query rows (one
// wgmma M tile). The block's C rows are split and staged once, hi and
// lo, as K-major tiles (N contiguous: 16-float atoms of 64-byte rows
// under the 64-byte swizzle). Key tiles of 32 rows of B (K-major, as
// C) and of x (transposed while staged: wgmma takes a TF32 B operand
// only K-major, and x is P-contiguous) pass through two shared-memory
// stages; all threads load tile t+1 from global memory into registers
// while the tensor cores run tile t, and split and store it after.
// There is no producer warp and no TMA: every element has to pass
// through a thread anyway to be split into hi and lo (and x to be
// transposed; a TMA map could not take the stride-0 head axis either).
// Per key tile and warpgroup:
//   S = C.B^T      wgmma m64n32k8 .tf32, A and B from shared memory;
//   W = S * exp(z_i - z_j) where j <= i, else 0, on S's accumulator
//                  fragment in registers;
//   Y += W.X       wgmma m64n64k8 .tf32 with W as the register A operand.
// The f32 accumulator holds columns 2t and 2t+1 of a k-step where the
// TF32 A fragment wants columns t and t+4; instead of moving W, the keys
// of every 8-key group are staged in x's tile in the order
// (0, 2, 4, 6, 1, 3, 5, 7), so accumulator pair (2t, 2t+1) IS the A
// fragment's (t, t+4) and W goes to the tensor cores as it lies. Key
// tiles wholly above a warpgroup's diagonal are skipped, and the row
// tiles with the most keys are scheduled first. The first key tile's
// loads are in flight while C is staged. A short last chunk, rows past
// it, columns past P and N are masked or zero-filled in the kernel. N pads to 16, 32, 64 or 128 (128 rows, 32-key tiles,
// 225 KB of shared memory in f32) or 256 (64 rows, 16-key tiles). Every
// CUDA error is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWgRows = 64;          // query rows of a warpgroup
constexpr int kWgThreads = 128;
constexpr int kPCols = 64;           // columns of P a block computes
constexpr int kAtomRow = 64;         // bytes of one atom row (16 f32)
constexpr int kMaxChunk = 256;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// Address of the 16-byte chunk `ch` (4 f32) of row r of atom a, in a
// tile of `rows` rows stored [atom][row][64 B] under the 64-byte swizzle
// (chunk c of row r sits at chunk c ^ ((r / 2) % 4)).
__device__ __forceinline__ uint32_t swz(uint32_t base, int a, int rows, int r,
                                        int ch) {
  return base + (a * rows + r) * kAtomRow + ((ch ^ ((r >> 1) & 3)) << 4);
}

// A wgmma operand descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 64-byte swizzle (2 in bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>((8 * kAtomRow) >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

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

// wgmma.mma_async m64nNk8, f32 += tf32 * tf32. _ss: A and B from shared
// memory, both K-major (C and B). _rs: A from registers (W), B from
// shared memory K-major (x transposed).
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// scale_d = 0 overwrites d instead of adding to it: the first product
// of a sum needs no zeroed accumulator (a register written by another
// instruction while a wgmma group is in flight serialises the groups).
template <int KEYS>
__device__ __forceinline__ void wgmma_s(float (&d)[KEYS / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (KEYS == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n16(d, da, db, scale_d);
}

// Four consecutive values of a row from global memory as f32, zero at
// and past `valid`; `vec` says the four are one aligned vector.
__device__ __forceinline__ void load4(const float* p, int valid, bool vec,
                                      float (&v)[4]) {
  if (vec && valid >= 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < valid ? p[u] : 0.f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int valid,
                                      bool vec, float (&v)[4]) {
  if (vec && valid >= 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < valid ? to_f32(p[u]) : 0.f;
}

// Two consecutive outputs (8-byte or 4-byte aligned) as one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store four values as hi (and, when LO, lo) TF32 chunks.
template <bool LO>
__device__ __forceinline__ void store_split(uint32_t hi_addr, uint32_t lo_addr,
                                            const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    h[u] = tf32_rna(v[u]);
    l[u] = tf32_rna(v[u] - __uint_as_float(h[u]));
  }
  st_shared_16(hi_addr, make_uint4(h[0], h[1], h[2], h[3]));
  if constexpr (LO) st_shared_16(lo_addr, make_uint4(l[0], l[1], l[2], l[3]));
}

// Tile plan for N padded to NA atoms of 16 floats and element type T.
template <typename T, int NA>
struct Plan {
  static constexpr bool kLo = sizeof(T) == 4;      // bf16 needs no lo
  static constexpr int kWgs = NA <= 8 ? 2 : 1;
  static constexpr int kRows = kWgs * kWgRows;
  static constexpr int kThreads = kWgs * kWgThreads;
  static constexpr int kKeys = NA <= 8 ? 32 : 16;
  static constexpr int kSplit = kLo ? 2 : 1;       // hi and lo copies
  static constexpr int kCBytes = NA * kRows * kAtomRow;         // one copy
  static constexpr int kBBytes = NA * kKeys * kAtomRow;
  static constexpr int kXBytes = (kKeys / 16) * kPCols * kAtomRow;
  static constexpr int kStageBytes = kSplit * (kBBytes + kXBytes);
  static constexpr int kSmem = kSplit * kCBytes + 2 * kStageBytes + 1024;
  // 16-byte tasks of one key tile: B rows x chunks, x columns x groups
  static constexpr int kBTasks = kKeys * NA * 4;
  static constexpr int kXTasks = kPCols * (kKeys / 4);
  static constexpr int kBPer = (kBTasks + kThreads - 1) / kThreads;
  static constexpr int kXPer = (kXTasks + kThreads - 1) / kThreads;
  static_assert(kSmem + 4 * kMaxChunk <= 232448, "over the shared memory");
};

template <typename T, int NA>
__global__ void __launch_bounds__(Plan<T, NA>::kThreads, 1)
ssd_chunk_kernel_wgmma(const T* __restrict__ x, const T* __restrict__ loga,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       T* __restrict__ y, int L, int H, int P, int N, int Q,
                       Strides xs, Strides ls, Strides bs, Strides cs,
                       int vec_b, int vec_c) {
  using Pl = Plan<T, NA>;
  constexpr int kKeys = Pl::kKeys;
  constexpr int kRows = Pl::kRows;
  constexpr int kThreads = Pl::kThreads;
  constexpr int kKSteps = kKeys / 8;       // k-steps of Y per key tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ float zs[kMaxChunk];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t c_hi = base;
  const uint32_t c_lo = c_hi + Pl::kCBytes;                  // if kLo
  const uint32_t st0 = base + Pl::kSplit * Pl::kCBytes;
  // stage s: [B hi | B lo | X hi | X lo]
  auto b_hi = [&](int s) { return st0 + s * Pl::kStageBytes; };
  auto b_lo = [&](int s) { return b_hi(s) + Pl::kBBytes; };
  auto x_hi = [&](int s) { return b_hi(s) + Pl::kSplit * Pl::kBBytes; };
  auto x_lo = [&](int s) { return x_hi(s) + Pl::kXBytes; };

  const int n_ps = (P + kPCols - 1) / kPCols;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int l0 = blockIdx.y * Q;
  const int qc = min(Q, L - l0);               // this chunk's length
  // the heaviest row tiles (most keys) first
  const int n_rt = (Q + kRows - 1) / kRows;
  const int i0 = (n_rt - 1 - static_cast<int>(blockIdx.z) / n_ps) * kRows;
  const int p0 = (blockIdx.z % n_ps) * kPCols;
  if (i0 >= qc) return;                        // the whole block: uniform
  const int n_keys = min(qc, i0 + kRows);      // chunk positions needed
  const int n_kt = (n_keys + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;

  const T* xb = x + b * xs.b + h * xs.h + static_cast<long long>(l0) * xs.l;
  const T* lb = loga + b * ls.b + h * ls.h + static_cast<long long>(l0) * ls.l;
  const T* bb = bm + b * bs.b + h * bs.h + static_cast<long long>(l0) * bs.l;
  const T* cb = cm + b * cs.b + h * cs.h + static_cast<long long>(l0) * cs.l;

  // Key-tile loads: B rows in natural order, x columns with each 8-key
  // group's keys in the order (0, 2, 4, 6, 1, 3, 5, 7).
  float rb[Pl::kBPer][4], rx[Pl::kXPer][4];
  auto load_tile = [&](int kt) {
#pragma unroll
    for (int q = 0; q < Pl::kBPer; ++q) {
      const int task = tid + q * kThreads;
      const int kk = task / (NA * 4), rem = task % (NA * 4);
      const int n = rem * 4, s = kt + kk;
#pragma unroll
      for (int u = 0; u < 4; ++u) rb[q][u] = 0.f;
      if (task < Pl::kBTasks && s < n_keys && n < N)
        load4(bb + static_cast<long long>(s) * bs.l + n, N - n, vec_b, rb[q]);
    }
#pragma unroll
    for (int q = 0; q < Pl::kXPer; ++q) {
      const int task = tid + q * kThreads;
      const int p = task % kPCols, gp = task / kPCols;
      const int s0 = kt + (gp >> 1) * 8 + (gp & 1);
      const bool ok = task < Pl::kXTasks && p0 + p < P;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + 2 * u;
        rx[q][u] = ok && s < n_keys
                       ? to_f32(xb[static_cast<long long>(s) * xs.l + p0 + p])
                       : 0.f;
      }
    }
  };
  auto store_tile = [&](int st) {
#pragma unroll
    for (int q = 0; q < Pl::kBPer; ++q) {
      const int task = tid + q * kThreads;
      if (task >= Pl::kBTasks) continue;
      const int kk = task / (NA * 4), rem = task % (NA * 4);
      const int a = rem / 4, ch = rem % 4;
      store_split<Pl::kLo>(swz(b_hi(st), a, kKeys, kk, ch),
                           swz(b_lo(st), a, kKeys, kk, ch), rb[q]);
    }
#pragma unroll
    for (int q = 0; q < Pl::kXPer; ++q) {
      const int task = tid + q * kThreads;
      if (task >= Pl::kXTasks) continue;
      const int p = task % kPCols, gp = task / kPCols;
      const int g8 = gp >> 1, par = gp & 1;
      const int a = g8 >> 1, ch = (g8 & 1) * 2 + par;
      store_split<Pl::kLo>(swz(x_hi(st), a, kPCols, p, ch),
                           swz(x_lo(st), a, kPCols, p, ch), rx[q]);
    }
  };
  // the first key tile in flight while C is staged
  load_tile(0);

  // loga of the chunk's first n_keys positions; thread 0 takes their
  // cumsum in order (f32), from registers 16 at a time, while the
  // others stage C and the first key tile.
  for (int s = tid; s < n_keys; s += kThreads) zs[s] = to_f32(lb[s * ls.l]);
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int s0 = 0; s0 < n_keys; s0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = s0 + u < n_keys ? zs[s0 + u] : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        run += v[u];
        if (s0 + u < n_keys) zs[s0 + u] = run;
      }
    }
  }

  // The block's C rows, split, zero past the chunk and past N; the
  // loads of up to 8 chunks a thread are in flight together.
  constexpr int kCPer = kRows * NA * 4 / kThreads;   // 2 NA
  constexpr int kCBatch = kCPer < 8 ? kCPer : 8;
  static_assert(kCPer % kCBatch == 0, "C staging batches");
  for (int i = 0; i < kCPer; i += kCBatch) {
    float v[kCBatch][4];
#pragma unroll
    for (int u = 0; u < kCBatch; ++u) {
      const int idx = tid + (i + u) * kThreads;
      const int r = idx / (NA * 4), n = (idx % (NA * 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
      if (i0 + r < qc && n < N)
        load4(cb + static_cast<long long>(i0 + r) * cs.l + n, N - n, vec_c,
              v[u]);
    }
#pragma unroll
    for (int u = 0; u < kCBatch; ++u) {
      const int idx = tid + (i + u) * kThreads;
      const int r = idx / (NA * 4), rem = idx % (NA * 4);
      store_split<Pl::kLo>(swz(c_hi, rem / 4, kRows, r, rem % 4),
                           swz(c_lo, rem / 4, kRows, r, rem % 4), v[u]);
    }
  }

  store_tile(0);
  // the generic-proxy stores must be visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // This thread's two rows of the accumulator fragments (chunk-local).
  const int wr0 = i0 + wg * kWgRows;
  const int row[2] = {wr0 + warp * 16 + lane / 4, wr0 + warp * 16 + lane / 4 + 8};
  const int wg_last = min(wr0 + kWgRows, qc) - 1;   // < wr0: no rows
  const int t4 = lane & 3;
  float zrow[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) zrow[e] = zs[min(row[e], n_keys - 1)];
  float acc[32];              // Y; its first product overwrites it
  float sc[kKeys / 2];
  uint32_t wh[kKSteps][4], wl[kKSteps][4];
  const uint32_t c_wg_hi = c_hi + wg * kWgRows * kAtomRow;
  const uint32_t c_wg_lo = c_lo + wg * kWgRows * kAtomRow;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int kt = it * kKeys;
    const bool active = kt <= wg_last;         // warpgroup-uniform
    if (active) {
      // S = C.B^T over N, 8 columns a step, as 3xTF32 (1 for bf16).
      // Y(it - 1) is still in flight on acc, wh and wl: no instruction
      // here may touch them.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * NA; ++kk) {
        const uint32_t off = (kk & 1) * 32;
        const uint32_t ca = (kk >> 1) * kRows * kAtomRow + off;
        const uint32_t ba = (kk >> 1) * kKeys * kAtomRow + off;
        if constexpr (Pl::kLo) {
          wgmma_s<kKeys>(sc, smem_desc(c_wg_lo + ca),
                         smem_desc(b_hi(st) + ba), kk > 0);
          wgmma_s<kKeys>(sc, smem_desc(c_wg_hi + ca),
                         smem_desc(b_lo(st) + ba), 1);
          wgmma_s<kKeys>(sc, smem_desc(c_wg_hi + ca),
                         smem_desc(b_hi(st) + ba), 1);
        } else {
          wgmma_s<kKeys>(sc, smem_desc(c_wg_hi + ca),
                         smem_desc(b_hi(st) + ba), kk > 0);
        }
      }
      wgmma_commit();
    }
    if (it + 1 < n_kt) load_tile(kt + kKeys);  // in flight meanwhile
    // S(it) and Y(it - 1) done; also in a warpgroup past its diagonal,
    // whose last Y may still read the stage that is refilled below
    wgmma_wait_all();
    if (active) {
      fence_regs(sc);
      fence_regs(acc);
      // W on S's fragment: sc[4i + e] is row row[e >> 1], key
      // kt + 8i + 2 t4 + (e & 1). Accumulator pair (2 t4, 2 t4 + 1) of
      // k-step i is the A fragment's (t4, t4 + 4): x's keys are staged
      // in that order.
#pragma unroll
      for (int i = 0; i < kKSteps; ++i) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + 8 * i + 2 * t4 + (e & 1);
          const int r = row[e >> 1];
          const bool ok = key <= r && r < qc;
          const float zk = zs[min(key, n_keys - 1)];
          w[e] = ok ? sc[4 * i + e] * expf(zrow[e >> 1] - zk) : 0.f;
        }
        // A fragment (row g, k t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
        const float wa[4] = {w[0], w[2], w[1], w[3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wh[i][e] = tf32_rna(wa[e]);
          wl[i][e] = tf32_rna(wa[e] - __uint_as_float(wh[i][e]));
        }
      }
      fence_regs(wh);
      fence_regs(wl);
      wgmma_fence();
      // Y += W.X over the tile's keys, 8 a step, as 3xTF32 (2 for bf16)
#pragma unroll
      for (int i = 0; i < kKSteps; ++i) {
        const uint32_t xa = (i >> 1) * kPCols * kAtomRow + (i & 1) * 32;
        wgmma_rs_n64(acc, wl[i], smem_desc(x_hi(st) + xa), it > 0 || i > 0);
        if constexpr (Pl::kLo)
          wgmma_rs_n64(acc, wh[i], smem_desc(x_lo(st) + xa), 1);
        wgmma_rs_n64(acc, wh[i], smem_desc(x_hi(st) + xa), 1);
      }
      wgmma_commit();
    }
    if (it + 1 < n_kt) {
      __syncthreads();     // every warpgroup is past Y(it - 1): stage free
      store_tile(st ^ 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // y: acc[4i + e] is row row[e >> 1], column p0 + 8i + 2 t4 + (e & 1).
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = row[e2];
    if (r > wg_last) continue;
    T* dst = y + ((static_cast<size_t>(b) * L + l0 + r) * H + h) * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = p0 + 8 * i + 2 * t4;
      const float v0 = acc[4 * i + 2 * e2], v1 = acc[4 * i + 2 * e2 + 1];
      if (c + 1 < P && (P & 1) == 0) {
        store2(dst + c, v0, v1);      // pairs of columns as one store
      } else {
        if (c < P) dst[c] = from_f32<T>(v0);
        if (c + 1 < P) dst[c + 1] = from_f32<T>(v1);
      }
    }
  }
}

template <typename T, int NA>
int launch_typed(const void* x, const void* loga, const void* bm,
                 const void* cm, void* y, int B, int L, int H, int P, int N,
                 int Q, Strides xs, Strides ls, Strides bs, Strides cs,
                 cudaStream_t stream) {
  using Pl = Plan<T, NA>;
  auto kernel = ssd_chunk_kernel_wgmma<T, NA>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Pl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  // four values of a row are one aligned vector when N, the strides and
  // the base pointer allow it
  auto vec = [&](const void* p, Strides s) {
    const long long v = 4;
    return N % 4 == 0 && s.b % v == 0 && s.l % v == 0 && s.h % v == 0 &&
           reinterpret_cast<uintptr_t>(p) % (v * sizeof(T)) == 0;
  };
  const int n_ps = (P + kPCols - 1) / kPCols;
  const dim3 grid(B * H, (L + Q - 1) / Q,
                  ((Q + Pl::kRows - 1) / Pl::kRows) * n_ps);
  kernel<<<grid, Pl::kThreads, Pl::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(loga),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), L, H, P, N, Q, xs, ls, bs, cs, vec(bm, bs) ? 1 : 0,
      vec(cm, cs) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* loga, const void* bm, const void* cm,
             void* y, int B, int L, int H, int P, int N, int Q, Strides xs,
             Strides ls, Strides bs, Strides cs, cudaStream_t stream) {
  // N pads to 16, 32, 64, 128 or 256 columns (1 to 16 atoms)
#define SSD_CASE(NA)                                                       \
  if (N <= 16 * NA)                                                        \
    return launch_typed<T, NA>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs,   \
                               ls, bs, cs, stream);
  SSD_CASE(1) SSD_CASE(2) SSD_CASE(4) SSD_CASE(8) SSD_CASE(16)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
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
    return launch_n<float>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs, ls, bs,
                           cs, st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, loga, bm, cm, y, B, L, H, P, N, Q, xs,
                                   ls, bs, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
