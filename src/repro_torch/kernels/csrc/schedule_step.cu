// Fused schedule pass for Hopper (sm_90a): one evaluation of the
// FitGpp scheduler's per-pass quantities over the (jobs, nodes) tile.
//
// Replaces src/repro/kernels/schedule_step.py::schedule_step_pallas
// (the TPU Pallas kernel, two sequential grid phases over 512-job
// blocks with a VMEM scratch reduction and indices carried in f32).
//
// Contract (bit-exact with the plain PyTorch version
// repro_torch/kernels/schedule_step.py::schedule_step_torch), per
// batch row b and job j:
//   scores[b,j]   Eq. 3: size/max_sz + s*(gp/max_gp), size = Eq. 1
//                 sqrt((x0*x0 + x1*x1) + x2*x2), x = demand/node_cap
//   fits[b,j,m]   free[m] >= demand[j] - eps on all three resources
//   fit_now[b,j]  row count of fits; fit_pend[b,j] the same count
//                 against free + pending_free
//   victim        Eq. 4 argmin of scores over cand & under & Eq. 2
//                 (best assigned node's min slack (free+d)-te >= -eps)
//   be_head       argmin queue_key over be_q
//   be_pick       argmin queue_key over be_q & fit_now >= width
//   nskip         #(be_q & fit_now < width & queue_key < key(be_pick))
// Every argmin takes the lowest index among ties; an empty mask gives
// -1. Indices are int32 end to end.
//
// Bound: at the main-path shape (B=1, J=65536, M=84) the pass is bound
// by bytes, chiefly the (J, M) int32 `fits` write (22 MB) and the
// (J, M) uint8 `assign` read (5.5 MB); the arithmetic is a few
// operations per (job, node). Design: the tile kernel streams one job
// row per thread with both node matrices staged in shared memory (6M
// floats, about 2 KB at M = 84). The block's assign rows come in, and
// its fits rows go out, through shared memory 32 nodes at a time, so a
// warp moves 32 consecutive nodes of one row (coalesced) while each
// thread still walks its own row. The block reduces the three
// (value, index) argmins; a one-block-per-batch-row finalize kernel
// reduces the per-block partials in a fixed order and counts nskip.
// No atomics, so the result is deterministic. Build with -fmad=false:
// a contracted multiply-add would round differently from the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // jobs (threads) per tile block
constexpr int kFinal = 1024;        // threads of the finalize block
constexpr int kChunk = 32;          // nodes staged per pass over a row
constexpr int kNone = 0x7fffffff;   // "no index" in an argmin pair
constexpr float kEps = 1e-9f;       // FIT_EPS as the float32 reference rounds it

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct ArgMin {
  float v;
  int i;
};

// Lexicographic (value, index) minimum: a total order, so any
// reduction order gives the same pair.
__device__ __forceinline__ ArgMin lex_min(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_min(ArgMin a) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = lex_min(a, o);
  }
  return a;
}

// Block-wide argmin; the result is valid in warp 0. Every thread of
// the block must call it (it synchronises twice).
template <int NT>
__device__ ArgMin block_min(ArgMin a, ArgMin* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_min(a);
  if (lane == 0) sh[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < NT / 32 ? sh[lane] : ArgMin{inf_f(), kNone};
    a = warp_min(a);
  }
  __syncthreads();
  return a;
}

__global__ void __launch_bounds__(kTile) tile_kernel(
    const float* __restrict__ demand, const float* __restrict__ gp,
    const int* __restrict__ width, const float* __restrict__ queue_key,
    const uint8_t* __restrict__ assign, const float* __restrict__ free_,
    const float* __restrict__ pend, const uint8_t* __restrict__ cand,
    const uint8_t* __restrict__ under, const uint8_t* __restrict__ be_q,
    const float* __restrict__ te_demand, const float* __restrict__ node_cap,
    const float* __restrict__ max_sz, const float* __restrict__ max_gp,
    const float* __restrict__ s_w, float* __restrict__ scores,
    int* __restrict__ fits, int* __restrict__ fit_now,
    int* __restrict__ fit_pend, float* __restrict__ part_val,
    int* __restrict__ part_idx, int J, int M) {
  // dynamic: [3M free | 3M free + pending]; static: one chunk of the
  // block's assign rows and fits rows, staged so that the global
  // reads and writes are coalesced (a warp moves consecutive nodes of
  // one row) while each thread still walks its own job's row
  extern __shared__ float sh_nodes[];
  __shared__ int sh_fit[kTile][kChunk + 1];
  __shared__ uint8_t sh_asg[kTile][kChunk + 4];
  __shared__ ArgMin sh_red[kTile / 32];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int rows = min(kTile, J - j0);  // the ragged last block is masked
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* fr = free_ + (size_t)b * M * 3;
  const float* pd = pend + (size_t)b * M * 3;
  for (int i = threadIdx.x; i < 3 * M; i += kTile) {
    const float f = fr[i];
    sh_nodes[i] = f;
    sh_nodes[3 * M + i] = f + pd[i];
  }

  const int j = j0 + threadIdx.x;
  const bool live = threadIdx.x < rows;
  const size_t bj = (size_t)b * J + j;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f;
  if (live) {
    d0 = demand[bj * 3 + 0];
    d1 = demand[bj * 3 + 1];
    d2 = demand[bj * 3 + 2];
    e0 = d0 - kEps;
    e1 = d1 - kEps;
    e2 = d2 - kEps;
    t0 = te_demand[b * 3 + 0];
    t1 = te_demand[b * 3 + 1];
    t2 = te_demand[b * 3 + 2];
  }
  const float* pf = sh_nodes + 3 * M;
  const size_t row0 = ((size_t)b * J + j0) * M;  // the block's first row
  int n_now = 0, n_pend = 0;
  float best = -inf_f();
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    const int mc = min(kChunk, M - m0);
    for (int r = warp; r < rows; r += kTile / 32)
      if (lane < mc) sh_asg[r][lane] = assign[row0 + (size_t)r * M + m0 + lane];
    __syncthreads();
    if (live) {
      for (int c = 0; c < mc; ++c) {
        const int m = m0 + c;
        const float f0 = sh_nodes[3 * m + 0];
        const float f1 = sh_nodes[3 * m + 1];
        const float f2 = sh_nodes[3 * m + 2];
        const int fit = (f0 >= e0) & (f1 >= e1) & (f2 >= e2);
        sh_fit[threadIdx.x][c] = fit;
        n_now += fit;
        n_pend += (pf[3 * m + 0] >= e0) & (pf[3 * m + 1] >= e1) &
                  (pf[3 * m + 2] >= e2);
        if (sh_asg[threadIdx.x][c]) {
          const float sl = fminf(fminf((f0 + d0) - t0, (f1 + d1) - t1),
                                 (f2 + d2) - t2);
          best = fmaxf(best, sl);
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kTile / 32)
      if (lane < mc) fits[row0 + (size_t)r * M + m0 + lane] = sh_fit[r][lane];
    __syncthreads();  // the next chunk reuses the staging buffers
  }

  ArgMin vic{inf_f(), kNone}, head{inf_f(), kNone}, pick{inf_f(), kNone};
  if (live) {
    const float x0 = d0 / node_cap[b * 3 + 0];
    const float x1 = d1 / node_cap[b * 3 + 1];
    const float x2 = d2 / node_cap[b * 3 + 2];
    const float size = sqrtf((x0 * x0 + x1 * x1) + x2 * x2);
    const float score = size / max_sz[b] + s_w[b] * (gp[bj] / max_gp[b]);
    scores[bj] = score;
    fit_now[bj] = n_now;
    fit_pend[bj] = n_pend;
    const float key = queue_key[bj];
    if (cand[bj] && under[bj] && best >= -kEps) vic = ArgMin{score, j};
    if (be_q[bj]) {
      head = ArgMin{key, j};
      if (n_now >= width[bj]) pick = ArgMin{key, j};
    }
  }
  vic = block_min<kTile>(vic, sh_red);
  head = block_min<kTile>(head, sh_red);
  pick = block_min<kTile>(pick, sh_red);
  if (threadIdx.x == 0) {
    const size_t p = ((size_t)b * gridDim.x + blockIdx.x) * 3;
    part_val[p + 0] = vic.v;
    part_idx[p + 0] = vic.i;
    part_val[p + 1] = head.v;
    part_idx[p + 1] = head.i;
    part_val[p + 2] = pick.v;
    part_idx[p + 2] = pick.i;
  }
}

__global__ void __launch_bounds__(kFinal) finalize_kernel(
    const float* __restrict__ part_val, const int* __restrict__ part_idx,
    int nb, const uint8_t* __restrict__ be_q, const int* __restrict__ width,
    const float* __restrict__ queue_key, const int* __restrict__ fit_now,
    int* __restrict__ out, int J) {
  __shared__ ArgMin sh_red[kFinal / 32];
  __shared__ int sh_idx[3];
  __shared__ float sh_pick_key;
  __shared__ int sh_cnt[kFinal / 32];
  const int b = blockIdx.x;
  for (int k = 0; k < 3; ++k) {
    ArgMin a{inf_f(), kNone};
    for (int i = threadIdx.x; i < nb; i += kFinal) {
      const size_t p = ((size_t)b * nb + i) * 3 + k;
      a = lex_min(a, ArgMin{part_val[p], part_idx[p]});
    }
    a = block_min<kFinal>(a, sh_red);
    if (threadIdx.x == 0) {
      sh_idx[k] = a.i == kNone ? -1 : a.i;
      // the pick's carried value IS queue_key[be_pick]
      if (k == 2) sh_pick_key = a.i == kNone ? inf_f() : a.v;
    }
  }
  __syncthreads();

  const float pick_key = sh_pick_key;
  int cnt = 0;
  const size_t base = (size_t)b * J;
  // the four loads of a job are unconditional and the tests combine
  // without short-circuit, so the unrolled loop keeps many loads in
  // flight (a short-circuit chain serialises them on this one block)
#pragma unroll 4
  for (int j = threadIdx.x; j < J; j += kFinal) {
    const size_t bj = base + j;
    const int q = be_q[bj] != 0;
    const int late = fit_now[bj] < width[bj];
    const int ahead = queue_key[bj] < pick_key;
    cnt += q & late & ahead;
  }
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) sh_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    cnt = sh_cnt[threadIdx.x];  // kFinal / 32 == 32 warps
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (threadIdx.x == 0) {
      out[b * 4 + 0] = sh_idx[0];
      out[b * 4 + 1] = sh_idx[1];
      out[b * 4 + 2] = sh_idx[2];
      out[b * 4 + 3] = cnt;
    }
  }
}

static_assert(kFinal / 32 == 32, "finalize sums one count per warp in warp 0");

// the tile kernel's static shared memory (staging buffers, reduction)
constexpr size_t kTileStaticSmem = sizeof(int) * kTile * (kChunk + 1) +
                                   kTile * (kChunk + 4) +
                                   sizeof(ArgMin) * (kTile / 32);

}  // namespace

// Launches both kernels on `stream` (PyTorch's current stream; no
// synchronisation, no allocation). Shapes: demand (B,J,3); gp,
// queue_key (B,J) f32; width (B,J) i32; assign (B,J,M) u8; free,
// pending_free (B,M,3); cand, under, be_q (B,J) u8; te_demand,
// node_cap (B,3); max_sz, max_gp, s (B,). Outputs scores (B,J) f32,
// fits (B,J,M) i32, fit_now, fit_pend (B,J) i32, out (B,4) i32 =
// (victim, be_head, be_pick, nskip); scratch part_val (B,nb,3) f32 and
// part_idx (B,nb,3) i32 with nb = ceil(J/256). A non-null `mid_event`
// (a cudaEvent_t) is recorded between the two kernels, for timing them
// apart. Returns the CUDA error code of the launches (0 on success).
extern "C" int schedule_step_launch(
    const float* demand, const float* gp, const int* width,
    const float* queue_key, const uint8_t* assign, const float* free_,
    const float* pending_free, const uint8_t* cand, const uint8_t* under,
    const uint8_t* be_q, const float* te_demand, const float* node_cap,
    const float* max_sz, const float* max_gp, const float* s_w,
    float* scores, int* fits, int* fit_now, int* fit_pend, int* out,
    float* part_val, int* part_idx, int B, int J, int M, void* stream,
    void* mid_event) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (J + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * 6 * (size_t)M;
  if (smem + kTileStaticSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tile_kernel<<<dim3(nb, B), kTile, smem, st>>>(
      demand, gp, width, queue_key, assign, free_, pending_free, cand, under,
      be_q, te_demand, node_cap, max_sz, max_gp, s_w, scores, fits, fit_now,
      fit_pend, part_val, part_idx, J, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mid_event != nullptr) {
    err = cudaEventRecord(static_cast<cudaEvent_t>(mid_event), st);
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<B, kFinal, 0, st>>>(part_val, part_idx, nb, be_q, width,
                                        queue_key, fit_now, out, J);
  return (int)cudaGetLastError();
}
