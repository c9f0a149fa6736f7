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
// Bound: a and b are read and h written once. At the recurrentgemma-9b
// prefill shape (B 4, L 4096, R 4096, f32) that is 805 MB, 0.240 ms at
// 3.35 TB/s; at the training shape (B 1) 201 MB, 0.060 ms. 2 FLOP an
// element is nothing next to it, and one channel's chain of 4,096
// dependent multiply-adds (about 8 cycles a step, ~19 us) is well under
// either. What holds a scan back is Little's law: to stream 3.35 TB/s
// at a loaded latency of ~1.3 us the card needs ~4 MB of loads in
// flight, and only loads made apart from the serial chain supply it.
//
// Two routes, chosen by the wrapper from shape, type and alignment alone
// (lru_scan.py::_route) and passed in as ``route``. Both walk every
// channel's time axis in order with one carry in a register and the
// same two rounded operations a step, so both are bit-equal to the
// plain version; they differ only in how a and b reach the registers.
//
// Route A, "tma" (a, b and out 16-byte aligned, R * sizeof(T) a
// multiple of 16: every call on the main paths). A block owns a slab of
// kW = 128 channels of one batch row and walks the whole time axis: the
// training shape (B 1, R 4096) runs 32 blocks, the prefill (B 4) 128.
// Four consumer warps hold one channel a thread; one thread of a
// producer warp keeps a ring of stages full, each stage a kTc x kW tile
// of a and one of b (a_{t+1} and g in reverse mode), loaded by
// cp.async.bulk.tensor.3d (TMA) from a (B, L, R) tensor map, with a
// full and an empty mbarrier per stage. So the loads run up to a whole
// ring ahead of the chain, not one thread's registers: in f32 a stage
// is 64 KB and the 192 KB ring holds 3, so the training shape has 32 x
// 192 KB = 6 MB in flight and the prefill 24 MB, against the ~4 MB
// Little's law asks (bf16: 4 stages of 32 KB). On an H100, slabs of 32
// channels (128 blocks at the training shape) were no faster, and a
// ring of 8 stages of 16 KB slower than 4 (lru_scan_ablation.py). A
// consumer warp reads one row of a tile a step, conflict-free, and
// stores h straight to device memory, one coalesced row a step; a full
// tile is one straight run of kTc steps with no branch, so the compiler
// hoists its shared-memory loads ahead of the chain. The map is 3-d,
// not a flattened (B*L, R) view, so rows past L, columns past R and, in
// reverse mode, a_{t+1} past L-1 and the last tile's negative start all
// read as TMA's zero fill, never a neighbouring batch row; the ragged
// tile masks its steps outside [0, L), and lanes past R skip the walk.
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
// after binding the device's context to the calling thread (autograd
// launches the reverse mode from a thread of its own). A failed map
// encode or launch returns its CUDA error: the wrapper raises, it never
// tries route B.
//
// Route B, "simple" (everything else: an R whose rows are not 16-byte
// multiples, an unaligned view). One thread per channel, 128 channels a
// block (blockIdx.x) of one batch row (blockIdx.y), so a warp's loads
// and stores of one time step are 128 consecutive bytes. Loads run kU
// steps ahead: the next group of kU (a, b) pairs is requested before
// the current group's dependent multiply-adds. Its bytes in flight are
// bounded by (channels) x kU x 8 B, 0.5 MB at B * R = 4,096, so it is
// latency-bound at small B * R. The ragged edges are masked, not padded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One step of the recurrence, rounded as the plain version rounds.
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---------------------------------------------------------------------
// Route B: one thread per channel, kU steps of loads ahead.

constexpr int kThreads = 128;    // channels per block
constexpr int kU = 16;           // time steps per load group

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
        h = step(ca[u], h, cb[u]);
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
int launch_simple(const void* a, const void* b, const float* h0, void* out,
                  int B, int L, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  lru_scan_kernel<Reverse, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(out), L, R, h0 != nullptr);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Route A: the TMA-fed scan. PTX wrappers first (as in flash_attention.cu;
// each source builds into a library of its own).

constexpr int kTc = 64;                  // time steps per stage
constexpr int kNW = 4;                   // consumer warps a block
constexpr int kW = 32 * kNW;             // channels a block
constexpr int kRingBytes = 192 * 1024;   // shared memory for the ring
constexpr int kMaxStages = 4;

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

// One box of a 3-d tensor map into shared memory, completing on ``bar``.
// Coordinates are signed: a box reaching below 0 or past a dimension's
// end reads zeros there.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// Blocks run over (batch row, slab); threads 0 .. kW-1 are the
// consumers (one channel each), warp kNW the producer. Tile k covers
// times [t0, t0 + kTc) with t0 = k*kTc (forward) or L - (k+1)*kTc
// (reverse, walked from its last row); its a tile starts one row later
// in reverse mode (a_{t+1}).
template <bool Reverse, typename T>
__global__ void __launch_bounds__(32 * (kNW + 1))
lru_scan_kernel_tma(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const float* __restrict__ h0, T* __restrict__ out, int L,
                    int R, int n_slabs, int stages) {
  constexpr int kBox = kTc * kW;                     // elements a tile
  constexpr uint32_t kBoxBytes = kBox * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const T* ring = reinterpret_cast<const T*>(smem);
  const uint32_t full = smem_u32(smem + 2 * kBoxBytes * stages);
  const uint32_t empty = full + 8 * stages;

  const int slab = blockIdx.x % n_slabs;
  const int bi = blockIdx.x / n_slabs;
  const int r0 = slab * kW;
  const int n_tiles = (L + kTc - 1) / kTc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's arrival
      mbar_init(empty + 8 * s, kNW);    // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kNW) {
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % stages;
        const int t0 = Reverse ? L - (k + 1) * kTc : k * kTc;
        const uint32_t dst = smem_u32(smem) + 2 * kBoxBytes * s;
        mbar_wait(empty + 8 * s, ((k / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kBoxBytes);
        tma_load_3d(dst, &a_map, full + 8 * s, r0, Reverse ? t0 + 1 : t0,
                    bi);
        tma_load_3d(dst + kBoxBytes, &b_map, full + 8 * s, r0, t0, bi);
      }
    }
    return;
  }

  // A full tile is one straight run of kTc steps, so the compiler can
  // start its shared-memory loads well ahead of the chain: no branch
  // inside it, and the h store's address moves by one row a step.
  const int c = threadIdx.x;               // the thread's column in the slab
  const int r = r0 + c;
  const bool live = r < R;                 // a lane past R only keeps time
  float h = h0 != nullptr && live ? h0[static_cast<size_t>(bi) * R + r] : 0.f;
  T* o = out + static_cast<size_t>(bi) * L * R + r;
  const ptrdiff_t row = Reverse ? -static_cast<ptrdiff_t>(R) : R;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % stages;
    const int t0 = Reverse ? L - (k + 1) * kTc : k * kTc;
    const T* ta = ring + static_cast<size_t>(2 * kBox) * s + c;
    const T* tb = ta + kBox;
    mbar_wait(full + 8 * s, (k / stages) & 1);
    if (live && t0 >= 0 && t0 + kTc <= L) {
      T* p = o + static_cast<size_t>(Reverse ? t0 + kTc - 1 : t0) * R;
#pragma unroll
      for (int j = 0; j < kTc; ++j) {
        const int i = Reverse ? kTc - 1 - j : j;
        h = step(to_f32(ta[i * kW]), h, to_f32(tb[i * kW]));
        *p = from_f32<T>(h);
        p += row;
      }
    } else if (live) {                       // the ragged tile: mask t
#pragma unroll 8
      for (int j = 0; j < kTc; ++j) {
        const int i = Reverse ? kTc - 1 - j : j;
        const int t = t0 + i;
        if (t >= 0 && t < L) {
          h = step(to_f32(ta[i * kW]), h, to_f32(tb[i * kW]));
          o[static_cast<size_t>(t) * R] = from_f32<T>(h);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
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

// x (B, L, R) as a 3-d map {R, L, B}, boxes of kW channels by kTc steps
// of one batch row; outside the tensor the box reads zeros.
template <typename T>
int scan_map(CUtensorMap* map, const void* ptr, int B, int L, int R) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(R) * sizeof(T);
  const cuuint64_t strides[2] = {row, row * L};     // bytes
  const cuuint32_t box[3] = {kW, kTc, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Makes the current device's primary context current in this thread:
// cuTensorMapEncodeTiled, a libcuda call, fails with
// CUDA_ERROR_INVALID_CONTEXT where it is not, and autograd's device
// thread may have made no runtime call that sets it.
int bind_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return static_cast<int>(err);
}

// Route A's inputs: 16-byte aligned bases and rows (TMA's rules).
bool tma_ok(const void* a, const void* b, const void* out, int R,
            int itemsize) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return aligned(a) && aligned(b) && aligned(out) &&
         (static_cast<long long>(R) * itemsize) % 16 == 0;
}

template <bool Reverse, typename T>
int launch_tma(const void* a, const void* b, const float* h0, void* out,
               int B, int L, int R, cudaStream_t stream) {
  constexpr int kStageBytes = 2 * kTc * kW * static_cast<int>(sizeof(T));
  constexpr int kStages = kRingBytes / kStageBytes < kMaxStages
                              ? kRingBytes / kStageBytes : kMaxStages;
  constexpr int kSmem = kStages * (kStageBytes + 16);   // ring + barriers
  if (!tma_ok(a, b, out, R, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slabs = (R + kW - 1) / kW;
  if (n_slabs * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = bind_device();
  if (err != 0) return err;
  CUtensorMap a_map = {}, b_map = {};
  err = scan_map<T>(&a_map, a, B, L, R);
  if (err == 0) err = scan_map<T>(&b_map, b, B, L, R);
  if (err != 0) return err;
  auto kernel = lru_scan_kernel_tma<Reverse, T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(n_slabs * B), 32 * (kNW + 1), kSmem,
           stream>>>(a_map, b_map, h0, static_cast<T*>(out), L, R,
                     static_cast<int>(n_slabs), kStages);
  return static_cast<int>(cudaGetLastError());
}

template <bool Reverse, typename T>
int launch(const void* a, const void* b, const float* h0, void* out, int B,
           int L, int R, int route, cudaStream_t stream) {
  if (route == 0)
    return launch_simple<Reverse, T>(a, b, h0, out, B, L, R, stream);
  if (route == 1)
    return launch_tma<Reverse, T>(a, b, h0, out, B, L, R, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = simple, 1 = tma; h0 may
// be null. Returns a cudaError_t (0 = launched).
extern "C" int lru_scan_launch(const void* a, const void* b, const void* h0,
                               void* out, int dtype, int B, int L, int R,
                               int route, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  if (dtype == 0)
    return launch<false, float>(a, b, h, out, B, L, R, route, st);
  if (dtype == 1)
    return launch<false, __nv_bfloat16>(a, b, h, out, B, L, R, route, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's reverse recurrence, f32: lam (B, L, R) from a and the
// upstream gradient g, both (B, L, R) f32; route as above. Returns a
// cudaError_t.
extern "C" int lru_scan_reverse_launch(const void* a, const void* g,
                                       void* lam, int B, int L, int R,
                                       int route, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, float>(a, g, nullptr, lam, B, L, R, route,
                             static_cast<cudaStream_t>(stream));
}
