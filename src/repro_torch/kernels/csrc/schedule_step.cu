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
//                 (best assigned node's min slack (free+d)-te >= -eps);
//                 with an akey (the stream engine's global arrival
//                 order) in (score, akey, index) order
//   be_head       argmin queue_key over be_q
//   be_pick       argmin queue_key over be_q & fit_now >= width
//   nskip         #(be_q & fit_now < width & queue_key < key(be_pick))
// Every argmin takes the lowest index among ties (the victim's after the
// smallest akey where one is given); an empty mask gives -1. Indices are
// int32 end to end. The kernel has two instantiations: with an akey, and
// without one (a null pointer), which carries and compares no key.
//
// Bound: at the main-path shape (B=1, J=65536, M=84) the pass is bound
// by bytes, chiefly the (J, M) int32 `fits` write (22 MB) and the
// (J, M) uint8 `assign` read (5.5 MB); the arithmetic is a few
// operations per (job, node).
//
// Design: ONE persistent cooperative launch a pass. The grid is as many
// 256-thread blocks as are resident at once (occupancy x SMs, capped at
// the tiles), and blocks walk the (b, 256-job tile) space grid-stride,
// so there is no tail wave and J beyond one resident wave works.
//  Phase A, per tile: one TMA bulk copy (cp.async.bulk, completing on an
//   mbarrier) brings the tile's assign rows, one contiguous slab of
//   rows*M bytes, into shared memory; an unaligned head or tail of the
//   slab (a ragged tile, odd M, a batch row at an unaligned offset) is
//   copied by plain loads in the same kernel. Each thread walks its own
//   job's row against the node vectors staged in shared memory (two
//   float4 a node, read as warp-wide broadcasts) and packs its fits
//   into words of 32 nodes in a shared array whose row stride is odd
//   (the threads' word writes hit distinct banks). A warp's 32 rows of
//   fits are one contiguous run of ints in global memory: as soon as
//   its rows are done, the warp stores the run in element order, int4
//   stores of full lines (scalar stores at an unaligned head or tail),
//   so warps that store overlap warps that still compute. Above kChunk
//   nodes the tile takes its nodes kChunk at a time: each range's
//   assign bytes by plain loads, each row's range of fits stored as its
//   own run. The three (value, index) argmins are reduced over the tile
//   and written as one partial per tile (the victim's akey beside it).
//  cooperative_groups::this_grid().sync().
//  Phase B: a block reduces the partials of each batch row it owns
//   tiles of, in index order with lex_min, a total order: every block
//   gets the same victim / be_head / be_pick and pick key.
//  Phase C: each block counts nskip over its own tiles' jobs (be_q,
//   width, queue_key and the fit_now it wrote, re-read from L2) and adds
//   the count to out with an integer atomicAdd: integer sums are exact
//   in any order, so the result stays deterministic (the float argmins
//   use no atomics). The block that owns a row's first tile zeroes its
//   nskip before the grid sync and writes its three indices after it.
// Build with -fmad=false: a contracted multiply-add would round
// differently from the plain version. Every CUDA error (a refused
// cooperative launch among them) is returned to the caller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;          // jobs (threads) per tile
constexpr int kChunk = 640;         // nodes a tile stages at a time
constexpr int kNone = 0x7fffffff;   // "no index" in an argmin pair
constexpr float kEps = 1e-9f;       // FIT_EPS as the float32 reference rounds it
// A tile stages all of its nodes at once only where M <= kChunk, so a
// whole-slab index (row * M + node, at most kTile * kChunk) is exact in
// a float and in an int; every index that grows with M or J is size_t.
static_assert(kTile * kChunk < (1 << 24), "slab indices must be exact floats");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct ArgMin {
  float v;  // the value minimised
  float k;  // the tie-break key (akey for the victim, else 0)
  int i;
};

// Lexicographic (value, key, index) minimum with kKey, else (value,
// index): a total order, so any reduction order gives the same result.
// Only the victim's argmin keys (and only with an akey): without one
// the key costs no shuffle and no compare.
template <bool kKey>
__device__ __forceinline__ ArgMin lex_min(ArgMin a, ArgMin b) {
  if (kKey)
    return (b.v < a.v ||
            (b.v == a.v && (b.k < a.k || (b.k == a.k && b.i < a.i))))
               ? b
               : a;
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

template <bool kKey>
__device__ __forceinline__ ArgMin warp_min(ArgMin a) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.k = kKey ? __shfl_xor_sync(0xffffffffu, a.k, off) : a.k;
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = lex_min<kKey>(a, o);
  }
  return a;
}

// The q-th argmin of a pass keys when it is the victim's (q = 0) and
// the pass has an akey.
template <bool kAkey>
__device__ __forceinline__ ArgMin warp_min_q(ArgMin a, int q) {
  return q == 0 ? warp_min<kAkey>(a) : warp_min<false>(a);
}

// Three block-wide argmins at once, valid in every thread. Every
// thread of the block must call it (it synchronises twice).
template <bool kAkey>
__device__ void block_min3(ArgMin (&a)[3], ArgMin (*sh)[3]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) a[q] = warp_min_q<kAkey>(a[q], q);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sh[warp][q] = a[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    a[q] = lane < kTile / 32 ? sh[lane][q] : ArgMin{inf_f(), 0.f, kNone};
    a[q] = warp_min_q<kAkey>(a[q], q);
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Shared-memory plan (dynamic), for ms = min(M, kChunk) nodes staged at
// a time: per node two float4, (free0, free1, free2, pf0) and (pf1, pf2,
// 0, 0) with pf = free + pending; the fits bits, kTile rows of `ws`
// words (ws odd, so the threads' word writes hit distinct banks); then
// the assign slab (kTile*ms bytes and 32 of slack for the 16-byte
// alignment of its copy).
__host__ __device__ inline int staged(int M) { return M < kChunk ? M : kChunk; }
__host__ __device__ inline int bit_words(int ms) { return ((ms + 31) / 32) | 1; }
__host__ __device__ inline size_t bits_offset(int ms) {
  return sizeof(float4) * 2 * static_cast<size_t>(ms);
}
__host__ __device__ inline size_t asg_offset(int ms) {
  return bits_offset(ms) + sizeof(uint32_t) * kTile * bit_words(ms);
}
__host__ __device__ inline size_t smem_bytes(int ms) {
  return asg_offset(ms) + static_cast<size_t>(kTile) * ms + 32;
}

// kAkey: the victim's argmin is keyed by akey (non-null); without it
// the kernel is the (score, index) pass.
template <bool kAkey>
__global__ void __launch_bounds__(kTile) schedule_step_kernel(
    const float* __restrict__ demand, const float* __restrict__ gp,
    const int* __restrict__ width, const float* __restrict__ queue_key,
    const uint8_t* __restrict__ assign, const float* __restrict__ free_,
    const float* __restrict__ pend, const uint8_t* __restrict__ cand,
    const uint8_t* __restrict__ under, const uint8_t* __restrict__ be_q,
    const float* __restrict__ te_demand, const float* __restrict__ node_cap,
    const float* __restrict__ max_sz, const float* __restrict__ max_gp,
    const float* __restrict__ s_w, float* __restrict__ scores,
    int* __restrict__ fits, int* fit_now, int* __restrict__ fit_pend,
    int* out, float* part_val, int* part_idx,
    const float* __restrict__ akey, int B, int J, int M) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ms = staged(M);
  float4* sh_nodes = reinterpret_cast<float4*>(smem);
  uint32_t* sh_bits = reinterpret_cast<uint32_t*>(smem + bits_offset(ms));
  uint8_t* sh_asg = smem + asg_offset(ms);
  __shared__ ArgMin sh_red[kTile / 32][3];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t bar = smem_u32(&bar_mem);
  const int tid = threadIdx.x;
  const int ws = bit_words(ms);
  const float inv_m = 1.0f / static_cast<float>(M);
  const int n_tiles = (J + kTile - 1) / kTile;
  const int total = B * n_tiles;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- phase A: the tiles, grid-stride ----
  uint32_t bar_uses = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / n_tiles, tile = t - b * n_tiles;
    const int j0 = tile * kTile;
    const int rows = min(kTile, J - j0);
    const size_t row0 = (static_cast<size_t>(b) * J + j0) * M;  // element
    const int j = j0 + tid;
    const bool live = tid < rows;
    const size_t bj = static_cast<size_t>(b) * J + j;
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
    const float* fr = free_ + static_cast<size_t>(b) * M * 3;
    const float* pd = pend + static_cast<size_t>(b) * M * 3;
    const int lane = tid & 31, warp = tid >> 5;
    const int r_beg = warp * 32, r_end = min(r_beg + 32, rows);
    int n_now = 0, n_pend = 0;
    float best = -inf_f();

    // Nodes [m0, m0 + mc) a round: all of them at once where M <=
    // kChunk, and then the tile's assign rows are one contiguous slab.
    for (int m0 = 0; m0 < M; m0 += kChunk) {
      const int mc = min(kChunk, M - m0);
      const bool whole = mc == M;
      // slab[r * mc + c] = assign[row0 + r * M + m0 + c]
      uint8_t* slab = sh_asg;
      bool bulk = false;
      if (whole) {
        // bytes [row0, row0 + n): the aligned middle by one bulk copy,
        // placed so that shared offsets mirror global alignment (M <=
        // kChunk here, so n <= kTile * kChunk)
        const int n = rows * M;
        const int mis = static_cast<int>(row0 & 15);
        const size_t a_beg = (row0 + 15) & ~size_t(15);
        const size_t a_end = (row0 + n) & ~size_t(15);
        bulk = a_end > a_beg;
        slab = sh_asg + mis;
        if (bulk && tid == 0) {
          const uint32_t bytes = static_cast<uint32_t>(a_end - a_beg);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              :: "r"(bar), "r"(bytes) : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];\n"
              :: "r"(smem_u32(slab + (a_beg - row0))),
                 "l"(assign + a_beg), "r"(bytes), "r"(bar)
              : "memory");
        }
        const int head = bulk ? static_cast<int>(a_beg - row0) : n;
        const int tail = bulk ? static_cast<int>(a_end - row0) : n;
        for (int e = tid; e < head; e += kTile) slab[e] = assign[row0 + e];
        for (int e = tail + tid; e < n; e += kTile)
          slab[e] = assign[row0 + e];
      } else {
        // rows of a node range are apart in global memory: plain loads
        for (int r = warp; r < rows; r += kTile / 32) {
          const uint8_t* src =
              assign + row0 + static_cast<size_t>(r) * M + m0;
          for (int c = lane; c < mc; c += 32) slab[r * mc + c] = src[c];
        }
      }
      for (int m = tid; m < mc; m += kTile) {
        const size_t g = 3 * (static_cast<size_t>(m0) + m);
        const float f0 = fr[g], f1 = fr[g + 1], f2 = fr[g + 2];
        sh_nodes[2 * m] = make_float4(f0, f1, f2, f0 + pd[g]);
        sh_nodes[2 * m + 1] =
            make_float4(f1 + pd[g + 1], f2 + pd[g + 2], 0.f, 0.f);
      }
      __syncthreads();                     // nodes and the plain bytes
      if (bulk) mbar_wait(bar, bar_uses & 1);
      bar_uses += bulk;

      // Each thread packs its row's fits into words of 32 nodes (4-byte
      // assign reads where mc is a multiple of 4, so every row starts
      // 4-aligned in the slab).
      const bool vec = (mc & 3) == 0;
      if (live) {
        const uint8_t* my = slab + tid * mc;
        for (int w = 0; w * 32 < mc; ++w) {
          const int c0w = w * 32, nc = min(32, mc - c0w);
          uint32_t word = 0;
          for (int c0 = 0; c0 < nc; c0 += 4) {
            uint32_t aw = 0;
            if (vec) {
              aw = *reinterpret_cast<const uint32_t*>(my + c0w + c0);
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (c0 + u < nc)
                  aw |= static_cast<uint32_t>(my[c0w + c0 + u]) << (8 * u);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int c = c0 + u;
              if (c >= nc) break;
              const float4 a = sh_nodes[2 * (c0w + c)];
              const float4 q = sh_nodes[2 * (c0w + c) + 1];
              word |= static_cast<uint32_t>((a.x >= e0) & (a.y >= e1) &
                                            (a.z >= e2)) << c;
              n_pend += (a.w >= e0) & (q.x >= e1) & (q.y >= e2);
              if ((aw >> (8 * u)) & 0xffu) {
                const float sl = fminf(
                    fminf((a.x + d0) - t0, (a.y + d1) - t1), (a.z + d2) - t2);
                best = fmaxf(best, sl);
              }
            }
          }
          sh_bits[tid * ws + w] = word;
          n_now += __popc(word);
        }
      }
      __syncwarp();

      auto bit = [&](int r, int m) -> int {    // r from the warp's r_beg
        return (sh_bits[(r_beg + r) * ws + (m >> 5)] >> (m & 31)) & 1u;
      };
      if (r_beg < r_end && whole) {
        // A warp's 32 rows of fits are one contiguous run of 32*M ints:
        // the warp stores it in element order as soon as its rows are
        // done, int4 stores where the address is 16-byte aligned,
        // scalars at the ends. M <= kChunk here, so n_w <= 32 * kChunk.
        const int n_w = (r_end - r_beg) * M;
        const size_t w0 = row0 + static_cast<size_t>(r_beg) * M;
        int* dst = fits + w0;
        const int head = min(n_w, static_cast<int>((4 - (w0 & 3)) & 3));
        const int nvec = (n_w - head) >> 2;
        // e = r * M + m, by a float reciprocal and one correction: e <
        // 2^24 is exact in a float, so e * inv_m is within a row of r
        auto split = [&](int e, int& r, int& m) {
          r = __float2int_rz(static_cast<float>(e) * inv_m);
          m = e - r * M;
          if (m < 0) {
            --r;
            m += M;
          } else if (m >= M) {
            ++r;
            m -= M;
          }
        };
        for (int q = lane; q < nvec; q += 32) {
          int r, m;
          split(head + 4 * q, r, m);
          int v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = bit(r, m);
            if (++m == M) {
              m = 0;
              ++r;
            }
          }
          *reinterpret_cast<int4*>(dst + head + 4 * q) =
              make_int4(v[0], v[1], v[2], v[3]);
        }
        for (int e = lane; e < head; e += 32) {
          int r, m;
          split(e, r, m);
          dst[e] = bit(r, m);
        }
        for (int e = head + 4 * nvec + lane; e < n_w; e += 32) {
          int r, m;
          split(e, r, m);
          dst[e] = bit(r, m);
        }
      } else if (r_beg < r_end) {
        // a node range: each of the warp's rows is its own run of mc ints
        for (int r = 0; r < r_end - r_beg; ++r) {
          int* dst = fits + row0 + static_cast<size_t>(r_beg + r) * M + m0;
          for (int m = lane; m < mc; m += 32) dst[m] = bit(r, m);
        }
      }
      if (m0 + kChunk < M) __syncthreads();  // smem free for the next range
    }

    // victim, be_head, be_pick
    ArgMin r[3] = {{inf_f(), 0.f, kNone}, {inf_f(), 0.f, kNone},
                   {inf_f(), 0.f, kNone}};
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
      if (cand[bj] && under[bj] && best >= -kEps)
        r[0] = ArgMin{score, kAkey ? akey[bj] : 0.f, j};
      if (be_q[bj]) {
        r[1] = ArgMin{key, 0.f, j};
        if (n_now >= width[bj]) r[2] = ArgMin{key, 0.f, j};
      }
    }
    block_min3<kAkey>(r, sh_red);          // also ends the tile's smem use
    if (tid == 0) {
      const size_t p = static_cast<size_t>(t) * 3;
      const size_t pv = static_cast<size_t>(t) * 4;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        part_val[pv + q] = r[q].v;
        part_idx[p + q] = r[q].i;
      }
      if (kAkey) part_val[pv + 3] = r[0].k;
      if (tile == 0) out[b * 4 + 3] = 0;
    }
  }

  cg::this_grid().sync();

  // ---- phases B and C: each owned tile's batch row, then its nskip ----
  int cur_b = -1;
  float pick_key = inf_f();
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / n_tiles, tile = t - b * n_tiles;
    if (b != cur_b) {
      cur_b = b;
      ArgMin r[3] = {{inf_f(), 0.f, kNone}, {inf_f(), 0.f, kNone},
                     {inf_f(), 0.f, kNone}};
      for (int i = tid; i < n_tiles; i += kTile) {
        const size_t ti = static_cast<size_t>(b) * n_tiles + i;
        const size_t p = ti * 3, pv = ti * 4;
        r[0] = lex_min<kAkey>(
            r[0], ArgMin{part_val[pv], kAkey ? part_val[pv + 3] : 0.f,
                         part_idx[p]});
#pragma unroll
        for (int q = 1; q < 3; ++q)
          r[q] = lex_min<false>(
              r[q], ArgMin{part_val[pv + q], 0.f, part_idx[p + q]});
      }
      block_min3<kAkey>(r, sh_red);
      // the pick's carried value IS queue_key[be_pick]
      pick_key = r[2].i == kNone ? inf_f() : r[2].v;
      if (tile == 0 && tid == 0) {
        out[b * 4 + 0] = r[0].i == kNone ? -1 : r[0].i;
        out[b * 4 + 1] = r[1].i == kNone ? -1 : r[1].i;
        out[b * 4 + 2] = r[2].i == kNone ? -1 : r[2].i;
      }
    }
    const int j = tile * kTile + tid;
    float late = inf_f();       // queue_key of a waiting job that does not fit
    if (j < J) {
      const size_t bj = static_cast<size_t>(b) * J + j;
      if (be_q[bj] && fit_now[bj] < width[bj]) late = queue_key[bj];
    }
    const int cnt = __syncthreads_count(late < pick_key);
    if (tid == 0 && cnt) atomicAdd(out + b * 4 + 3, cnt);
  }
}

struct LaunchShape {       // the occupancy of the last (device, M) seen
  int dev = -1;
  int M = -1;
  int per_sm = 0;
  int sms = 0;
};

// Refreshes `shape` for `kernel` (one instantiation) at M nodes on `dev`.
cudaError_t update_shape(const void* kernel, int dev, int M, size_t smem,
                         LaunchShape& shape) {
  if (dev == shape.dev && M == shape.M) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  shape.dev = dev;
  shape.M = M;
  shape.per_sm = per_sm;
  shape.sms = sms;
  return cudaSuccess;
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream; no
// synchronisation, no allocation) as one cooperative launch. Shapes:
// demand (B,J,3); gp, queue_key (B,J) f32; width (B,J) i32; assign
// (B,J,M) u8; free, pending_free (B,M,3); cand, under, be_q (B,J) u8;
// te_demand, node_cap (B,3); max_sz, max_gp, s (B,). Outputs scores
// (B,J) f32, fits (B,J,M) i32, fit_now, fit_pend (B,J) i32, out (B,4)
// i32 = (victim, be_head, be_pick, nskip); scratch part_val (B,nt,4)
// f32 (three values and the victim's akey) and part_idx (B,nt,3) i32
// with nt = ceil(J/256), one partial per tile. akey (B,J) f32, or null
// for the (score, index) victim order. Returns the CUDA error code (0
// on success).
extern "C" int schedule_step_launch(
    const float* demand, const float* gp, const int* width,
    const float* queue_key, const uint8_t* assign, const float* free_,
    const float* pending_free, const uint8_t* cand, const uint8_t* under,
    const uint8_t* be_q, const float* te_demand, const float* node_cap,
    const float* max_sz, const float* max_gp, const float* s_w,
    float* scores, int* fits, int* fit_now, int* fit_pend, int* out,
    float* part_val, int* part_idx, const float* akey, int B, int J, int M,
    void* stream) {
  static thread_local LaunchShape shapes[2];   // without, with akey
  if (B < 1 || J < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(staged(M));
  const bool keyed = akey != nullptr;
  const void* kernel =
      keyed ? reinterpret_cast<const void*>(schedule_step_kernel<true>)
            : reinterpret_cast<const void*>(schedule_step_kernel<false>);
  LaunchShape& shape = shapes[keyed];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = update_shape(kernel, dev, M, smem, shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>(B) * ((J + kTile - 1) / kTile);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(shape.per_sm) * shape.sms
          ? tiles
          : static_cast<long long>(shape.per_sm) * shape.sms);
  void* args[] = {&demand,   &gp,       &width,    &queue_key, &assign,
                  &free_,    &pending_free, &cand, &under,     &be_q,
                  &te_demand, &node_cap, &max_sz,  &max_gp,    &s_w,
                  &scores,   &fits,     &fit_now,  &fit_pend,  &out,
                  &part_val, &part_idx, &akey,     &B,         &J,
                  &M};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kTile), args,
                                    smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
