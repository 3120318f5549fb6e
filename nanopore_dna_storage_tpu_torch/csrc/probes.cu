// Merge-family probe kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU probes of scripts/:
// - merge: tpu_vpu_roofline.py `make_merge_kernel` (pallas_call in `run`,
//   tpu_vpu_roofline.py:104): `rounds` rounds of the suppression merge over
//   64 candidates per column (max, first argmax, its two hashes, dual-hash
//   knockout), summing best + (h1 + h2) over the rounds;
// - stream: tpu_vpu_roofline.py `make_stream_kernel` (same pallas_call):
//   12 elementwise max / add / select ops per element and round, then a max
//   over the 64 candidates;
// - treepop: tpu_treepop_probe.py `make` (pallas_call in `run`,
//   tpu_treepop_probe.py:80) and the guarded pair tree of `run_when`
//   (tpu_treepop_probe.py:121): max plus the winner's int32 payload over the
//   candidate axis, in the index order of each variant.
// The plain PyTorch versions are probes/merge_roofline.py `merge_ref`,
// `stream_ref` and probes/treepop.py `treepop_ref`; each kernel is held
// against its plain version bit for bit.
//
// What bounds them on this card: operations, and most of them compares,
// selects and min / max, which issue at half the FP32 rate (the ALU pipe,
// 64 lanes an SM against 128 for FADD; `issue_kernel` below measures each
// kind's rate and merge_roofline.pipe_floor turns a kernel's SASS into its
// floor). Both kernels compute every one of the G copies over the one input
// with threads of their own and write each copy to its own slot [G,
// columns], so the compiler cannot drop any copy's work; the input (3 x 64 x
// 4096 x 4 B = 3 MiB at the probe's shape) stays in L2 for all copies.
//
// merge: the 64 candidates x (score, h1, h2) of a column live in registers,
// split over G = kMergeLanes lanes: lane l holds the candidates of flat
// index j * G + l, j < 64 / G. A block of 256 threads is one tile of 32 / G
// columns for 8 copies: the tile's 64 rows are loaded once into shared
// memory, and each lane copies its candidates from there. Every loop over
// candidates is unrolled, so no array leaves the registers. Each round: a
// local tree max over the lane's candidates (adjacent pairs, the right
// child taken only on a strict `>`, so the lowest index of the maximum
// wins), log2 G butterfly shuffles on (score, flat index) in which the
// lower index wins a tie, the winner's two hashes read back from the tile
// at its flat index, then every lane knocks out its own candidates. Every
// round does the full max and the full knockout: nothing is skipped on the
// data. On an H100 80GB HBM3 at 700 W, at the probe's shape, G = 2 takes
// 0.22 ms (122 registers, no local memory, 512 threads per SM), about 87%
// of its pipe floor; G = 1, 4 and 8 took 0.24, 0.24 and 0.30 ms, and
// forms that loaded each lane's candidates from L2 and picked the winner's
// hashes by select trees on its index and a shuffle from its owner 0.29
// to 0.40 ms, the select trees a fifth of the ALU work (PERF.md). The
// first form of this kernel kept the candidates in arrays indexed at run
// time (768 B of local memory a thread) and scanned them: 2.74 ms.
//
// stream: the chain is elementwise, so each thread runs VEC = 2 columns of
// one copy side by side (8-byte loads and stores), two independent chains
// for the scheduler, with the 8 rounds unrolled at compile time; other
// round counts, odd column counts and unaligned tensors go to the VEC = 1,
// run-time-rounds instantiation of the same kernel. Each element
// and round keeps its 12 ops in order: 4 FMNMX, 4 FSETP with 4 FSEL, 4
// FADD. On the same card VEC = 2 is the fastest, 0.43 ms, about 92% of
// its floor (VEC = 1 and 4 took 0.45 and 0.46 ms), where the first form
// (VEC = 1, rounds in a loop) took 0.52 ms, about 76%.
//
// treepop: each variant is a fixed pairing of 64 slots, slot v holding a
// candidate or -inf (payload 0) after a map the launcher computes from the
// variant and nc (`TreeRows`): argmax, reshape_pair and concat pair
// adjacent slots (the first maximum over the first n, 2^floor(log2 n) and
// min(n, 60) candidates: a pair tree that drops or carries an odd last
// entry reduces to that, and a -inf right child never wins on a strict `>`);
// halves pairs slot i with i + m, its candidates placed at the slots where
// that tree pairs them for the n given. A column's 64 slots lie in
// registers over G lanes (1, 2, 4 or 8, adjacent lanes of a warp): for
// the adjacent pairings lane l holds slots [l 64/G, (l+1) 64/G), for
// halves slots j G + l, so that the levels above G pair within a lane.
// Each lane runs its part of the tree unrolled, then log2 G shuffle steps
// finish it: at offset s the lane whose bit s is clear holds the pair's
// first entry, and the second wins only if strictly greater (adjacent
// pairings step s = 1, 2, ...; halves s = G/2, ..., 1). The launcher takes
// the fewest lanes that give every SM a block, at most 8: G = 8 at the
// probe's 1024 columns, G = 1 at 262,144. Loads are whole sectors from 8
// columns on (G <= 4), the guard is read by every thread, and a failed
// guard writes the zeros itself, so one launch is the whole call. On an
// H100 80GB HBM3 at 700 W, from CUDA graphs at [64, 8, 128] (G = 8, 37
// registers) 1.73-1.93 us a call, where an empty kernel takes 0.83-1.15
// us; at [64, 8, 32768] (G = 1, 168 registers) 0.047-0.052 ms, ~80% of the
// 0.0407 ms its bytes need. The first form (one thread a column, the 64
// candidates in arrays indexed at run time, a 512-byte stack frame) took
// 9.4-15.8 us and 0.21-0.23 ms (PERF.md).
//
// Exactness: no --use_fast_math and no -ftz, so the denormals among the
// stream's bitcast hashes (bit patterns below 2^23) survive; --fmad=false
// stays, though nothing here multiplies. max is PTX max.NaN.f32, which
// propagates NaN as jnp.maximum and torch.maximum do. Compares are strict
// `>`, so the first maximum wins a tie (+0.0 and -0.0 compare equal); an
// all -inf column selects index 0, as jnp.argmax and torch.argmax do, and
// that index's hashes do the knockout. The merge adds the int32 sum h1 + h2,
// converts it to f32 once and adds it to the best score, then adds that to
// the total in round order. Its domain is finite scores and -inf: it never
// picks a NaN, where torch.argmax would.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNc = 64;  // candidates per column, NC of the TPU probes
constexpr int kBlock = 128;
constexpr int kMergeLanes = 2;  // lanes a merge column is split over
constexpr int kMergeBlock = 256;  // a merge block: 8 copies of a tile
constexpr int kConcatN = 60;  // the concat variant's odd-length start
constexpr int kTreeBlock = 64;  // a tree-pop block: 128 blocks at 1024 x 8
constexpr int kStreamRounds = 8;  // the probe's rounds, unrolled

enum Variant { kArgmax = 0, kReshapePair = 1, kHalves = 2, kConcat = 3 };

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The lowest-index maximum of cs[LO, LO + N) as (score, index): the two
// halves reduced depth first, then the right half taken only if strictly
// greater, so the left, lower indices win a tie. Every index is a
// compile-time constant. (csrc/lva_lse.cu's helper, kept apart so that the
// decoder's kernels build as they do alone.)
template <int LO, int N, int M>
__device__ __forceinline__ void tree_max(const float (&cs)[M], float& v,
                                         int& k) {
  if constexpr (N == 1) {
    v = cs[LO];
    k = LO;
  } else {
    float v1;
    int k1;
    tree_max<LO, N / 2>(cs, v, k);
    tree_max<LO + N / 2, N / 2>(cs, v1, k1);
    const bool right = v1 > v;
    v = right ? v1 : v;
    k = right ? k1 : k;
  }
}

// One (copy, column) per group of G adjacent lanes; warp w of a block is
// copy blockIdx.y * 8 + w over tile blockIdx.x. A group past the last copy
// or column runs on -inf candidates and writes nothing, so that every lane
// of a warp reaches the shuffles (a partial mask made nvcc add a divergent
// slow path to each shuffle).
__global__ void __launch_bounds__(kMergeBlock) merge_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h1,
    const uint32_t* __restrict__ h2, float* __restrict__ out, int nc,
    int ncol, int rounds, int copies) {
  constexpr int G = kMergeLanes;
  constexpr int N = kMaxNc / G;  // candidates a lane holds
  constexpr int TC = 32 / G;  // columns of a tile: one warp's groups
  constexpr int CP = kMergeBlock / 32;  // copies that share it
  __shared__ float s_x[kMaxNc][TC];
  __shared__ uint32_t s_h1[kMaxNc][TC], s_h2[kMaxNc][TC];
  const int lane = threadIdx.x % G;
  const int c = threadIdx.x % 32 / G;  // the group's column in the tile
  const int col0 = blockIdx.x * TC;
  // candidates past nc are -inf: under a strict `>` they never win and
  // never change which index wins, and knocking one out changes nothing
#pragma unroll
  for (int s = 0; s < kMaxNc * TC / kMergeBlock; ++s) {
    const int e = s * kMergeBlock + threadIdx.x;
    const int i = e / TC, k = e % TC;
    const bool in = i < nc && col0 + k < ncol;
    const size_t at = static_cast<size_t>(i) * ncol + col0 + k;
    s_x[i][k] = in ? __ldg(x + at) : -INFINITY;
    s_h1[i][k] = in ? __ldg(h1 + at) : 0u;
    s_h2[i][k] = in ? __ldg(h2 + at) : 0u;
  }
  __syncthreads();
  const int copy = blockIdx.y * CP + static_cast<int>(threadIdx.x / 32);
  const int col = col0 + c;
  float cs[N];
  uint32_t c1[N], c2[N];
  // row j * G + l: the lanes of a warp read 32 different banks
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = j * G + lane;
    cs[j] = s_x[i][c];
    c1[j] = s_h1[i][c];
    c2[j] = s_h2[i][c];
  }
  float acc = 0.0f;  // sum(outs) starts from 0
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float best;
    int j;
    tree_max<0, N>(cs, best, j);
    int fi = j * G + lane;  // flat index of the lane's winner
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, off, G);
      const int f2 = __shfl_xor_sync(0xffffffffu, fi, off, G);
      const bool take = v2 > best || (v2 == best && f2 < fi);
      best = take ? v2 : best;
      fi = take ? f2 : fi;
    }
    // the winner's hashes from the tile, at its flat index: the groups of
    // a warp read different banks
    const uint32_t a = s_h1[fi][c];
    const uint32_t b = s_h2[fi][c];
#pragma unroll
    for (int i = 0; i < N; ++i)
      cs[i] = c1[i] == a && c2[i] == b ? -INFINITY : cs[i];
    // the int32 sum first, then one f32 conversion and one f32 add
    const float o = best + static_cast<float>(static_cast<int32_t>(a + b));
    acc = acc + o;
  }
  if (copy < copies && col < ncol && lane == 0)
    out[static_cast<size_t>(copy) * ncol + col] = acc;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One round of the stream's chain on one element, its 12 ops in order.
__device__ __forceinline__ float stream_round(float acc, float b, float c) {
  const float t1 = max_nan(acc, b);
  const float t2 = acc + c;
  const float t3 = acc > b ? c : acc;
  const float t4 = max_nan(t1, t2);
  const float t5 = t3 + t1;
  const float t6 = t2 > t3 ? t4 : t5;
  const float t7 = t4 + t6;
  const float t8 = max_nan(t5, t7);
  const float t9 = t6 > t7 ? t8 : t1;
  const float t10 = t8 + t9;
  const float t11 = max_nan(t9, t10);
  return t10 > t11 ? acc : t11;
}

// One thread per (copy, VEC adjacent columns); R > 0 unrolls R rounds, R = 0
// runs `rounds` of them.
template <int VEC, int R>
__global__ void __launch_bounds__(kBlock) stream_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h1,
    const uint32_t* __restrict__ h2, float* __restrict__ out, int nc,
    int ncol, int rounds, int copies) {
  const int nvec = ncol / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= static_cast<int64_t>(copies) * nvec) return;
  const int copy = static_cast<int>(t / nvec);
  const int col = static_cast<int>(t % nvec) * VEC;
  float res[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) res[v] = -INFINITY;
  // elementwise, so each element runs all its rounds in registers
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    const size_t k = static_cast<size_t>(i) * ncol + col;
    float acc[VEC], b[VEC], c[VEC];
    load_vec<VEC>(x + k, acc);
    load_vec<VEC>(reinterpret_cast<const float*>(h1) + k, b);
    load_vec<VEC>(reinterpret_cast<const float*>(h2) + k, c);
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = stream_round(acc[v], b[v], c[v]);
    } else {
      for (int r = 0; r < rounds; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = stream_round(acc[v], b[v], c[v]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) res[v] = max_nan(res[v], acc[v]);
  }
  store_vec<VEC>(out + static_cast<size_t>(copy) * ncol + col, res);
}

// Issue-rate chains: each thread updates kChains words kSteps times an
// iteration, every new word from three old ones of other chains, so no
// chain folds into fewer instructions than it names and the kChains updates
// of a step are independent. merge_roofline.issue_rates reads the SASS
// count of each kind in the loop body and divides by the time.
enum IssueKind {
  kFadd = 0, kFmnmx = 1, kFsetpFsel = 2, kIsetpSel = 3, kShfl = 4,
  kIadd3 = 5, kLop3 = 6, kImad = 7, kFaddFmnmx = 8
};
constexpr int kChains = 8;
constexpr int kSteps = 16;

template <int K>
__device__ __forceinline__ uint32_t issue_op(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t d;
  const float fa = __uint_as_float(a), fb = __uint_as_float(b),
              fc = __uint_as_float(c);
  float fd;
  if constexpr (K == kFadd) {
    asm volatile("add.rn.f32 %0, %1, %2;" : "=f"(fd) : "f"(fa), "f"(fb));
    d = __float_as_uint(fd);
  } else if constexpr (K == kFmnmx) {
    asm volatile("max.f32 %0, %1, %2;" : "=f"(fd) : "f"(fa), "f"(fb));
    d = __float_as_uint(fd);
  } else if constexpr (K == kFsetpFsel) {
    asm volatile("{ .reg .pred p; setp.gt.f32 p, %1, %2; "
                 "selp.f32 %0, %3, %1, p; }"
                 : "=f"(fd) : "f"(fa), "f"(fb), "f"(fc));
    d = __float_as_uint(fd);
  } else if constexpr (K == kIsetpSel) {
    asm volatile("{ .reg .pred p; setp.eq.u32 p, %1, %2; "
                 "selp.b32 %0, %3, %1, p; }"
                 : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (K == kShfl) {
    asm volatile("shfl.sync.bfly.b32 %0, %1, 1, 0x1f, 0xffffffff;"
                 : "=r"(d) : "r"(b));
  } else if constexpr (K == kIadd3) {
    asm volatile("{ .reg .u32 t; add.u32 t, %1, %2; add.u32 %0, t, %3; }"
                 : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (K == kLop3) {
    asm volatile("lop3.b32 %0, %1, %2, %3, 0x6a;"
                 : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (K == kImad) {
    asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                 : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else {  // kFaddFmnmx: one of each, dependent
    asm volatile("{ .reg .f32 t; add.rn.f32 t, %1, %2; max.f32 %0, t, %3; }"
                 : "=f"(fd) : "f"(fa), "f"(fb), "f"(fc));
    d = __float_as_uint(fd);
  }
  return d;
}

template <int K>
__global__ void __launch_bounds__(kBlock) issue_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int iters) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  uint32_t a[kChains];
#pragma unroll
  for (int q = 0; q < kChains; ++q) a[q] = in[q] ^ static_cast<uint32_t>(t);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t n[kChains];
#pragma unroll
      for (int q = 0; q < kChains; ++q)
        n[q] = issue_op<K>(a[q], a[(q + 1) % kChains], a[(q + 2) % kChains]);
#pragma unroll
      for (int q = 0; q < kChains; ++q) a[q] = n[q];
    }
  }
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < kChains; ++q) r ^= a[q];
  out[t] = r;
}

// The tree pop's 64 slots: slot v holds candidate row r[v], or -inf with
// payload 0 where r[v] < 0; r[v] == v for v < n. The kernel reads r only
// past n: lanes that index a parameter with different slots are served
// one address at a time (0.18-0.2 us a call at [64, 8, 128], PERF.md).
struct TreeRows {
  int8_t r[kMaxNc];
  int n;
};

// The first of a pair keeps its place unless the second is strictly
// greater.
__device__ __forceinline__ void pair_keep(float& v, int32_t& p, float v2,
                                          int32_t p2) {
  const bool tk = v2 > v;
  v = tk ? v2 : v;
  p = tk ? p2 : p;
}

// The halves tree over v, p [N]: the level of M pairs j with j + M, then
// the level of M / 2. (A loop over the levels nested around one over j
// stayed rolled and put the arrays in local memory.)
template <int M, int N>
__device__ __forceinline__ void halves_levels(float (&v)[N],
                                              int32_t (&p)[N]) {
  if constexpr (M >= 1) {
#pragma unroll
    for (int j = 0; j < M; ++j) pair_keep(v[j], p[j], v[j + M], p[j + M]);
    halves_levels<M / 2>(v, p);
  }
}

// One column per group of G adjacent lanes. A group past the last column
// runs on the last column and writes nothing, so that every lane of a warp
// reaches the shuffles.
template <int V, int G>
__global__ void __launch_bounds__(kTreeBlock) treepop_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ h,
    float* __restrict__ out, int32_t* __restrict__ out_h, int ncol,
    int guarded, const __grid_constant__ TreeRows rows) {
  constexpr int N = kMaxNc / G;  // slots a lane holds
  constexpr bool kHalvesTree = V == kHalves;
  const int lane = threadIdx.x % G;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (kTreeBlock / G) +
                    threadIdx.x / G;
  const bool live = c < ncol;
  const int col = live ? static_cast<int>(c) : ncol - 1;
  // run_when's pl.when: one value for the whole grid
  if (guarded && !(__ldg(x) < 1e9f)) {
    if (live && lane == 0) {
      out[col] = 0.0f;
      out_h[col] = 0;
    }
    return;
  }
  float v[N];
  int32_t p[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int slot = kHalvesTree ? j * G + lane : lane * N + j;
    const int r = slot < rows.n ? slot : rows.r[slot];
    const size_t at = static_cast<size_t>(r < 0 ? 0 : r) * ncol + col;
    v[j] = r < 0 ? -INFINITY : __ldg(x + at);
    p[j] = r < 0 ? 0 : __ldg(h + at);
  }
  // the lane's part of the tree, every index a compile-time constant
  if constexpr (kHalvesTree) {
    halves_levels<N / 2>(v, p);
  } else {
#pragma unroll
    for (int w = 1; w < N; w *= 2)
#pragma unroll
      for (int j = 0; j < N; j += 2 * w)
        pair_keep(v[j], p[j], v[j + w], p[j + w]);
  }
  // the levels across lanes: the lane whose bit s is clear holds the first
  // entry of the pair
#pragma unroll
  for (int k = 0; (1 << k) < G; ++k) {
    const int s = kHalvesTree ? G >> (k + 1) : 1 << k;
    const float v2 = __shfl_xor_sync(0xffffffffu, v[0], s, G);
    const int32_t p2 = __shfl_xor_sync(0xffffffffu, p[0], s, G);
    const bool tk = lane & s ? !(v[0] > v2) : v2 > v[0];
    v[0] = tk ? v2 : v[0];
    p[0] = tk ? p2 : p[0];
  }
  if (live && lane == 0) {
    out[col] = v[0];
    out_h[col] = p[0];
  }
}

// The slots of `variant` over nc candidates (see the header).
TreeRows tree_rows(int variant, int nc) {
  TreeRows t;
  int lg = 0;  // floor(log2 nc)
  while ((2 << lg) <= nc) ++lg;
  for (int v = 0; v < kMaxNc; ++v) {
    int r = -1;
    if (variant == kHalves) {
      // levels k < lg pair i with i + (nc >> (k + 1)); slot v's high lg
      // bits say which side it takes at each level
      const int low = kMaxNc / (1 << lg) - 1;
      if ((v & low) == 0) {
        const int u = v / (low + 1);
        r = 0;
        for (int k = 0; k < lg; ++k)
          if (u >> (lg - 1 - k) & 1) r += nc >> (k + 1);
      }
    } else {
      const int n = variant == kArgmax ? nc
                    : variant == kConcat ? (nc < kConcatN ? nc : kConcatN)
                                         : 1 << lg;
      r = v < n ? v : -1;
    }
    t.r[v] = static_cast<int8_t>(r);
  }
  t.n = 0;
  while (t.n < kMaxNc && t.r[t.n] == t.n) ++t.n;
  return t;
}

using TreeFn = void (*)(const float*, const int32_t*, float*, int32_t*, int,
                        int, const TreeRows);

template <int V>
TreeFn tree_fn_lanes(int lanes) {
  switch (lanes) {
    case 1: return treepop_kernel<V, 1>;
    case 2: return treepop_kernel<V, 2>;
    case 4: return treepop_kernel<V, 4>;
    case 8: return treepop_kernel<V, 8>;
    default: return nullptr;
  }
}

TreeFn tree_fn(int variant, int lanes) {
  switch (variant) {
    case kArgmax: return tree_fn_lanes<kArgmax>(lanes);
    case kReshapePair: return tree_fn_lanes<kReshapePair>(lanes);
    case kHalves: return tree_fn_lanes<kHalves>(lanes);
    case kConcat: return tree_fn_lanes<kConcat>(lanes);
    default: return nullptr;
  }
}

// The fewest lanes (1, 2, 4, 8) that give every SM of the current device a
// block of the tree pop over ncol columns; 0 if the device query fails.
int tree_lanes(int ncol) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int g = 1;
  while (g < 8 && static_cast<int64_t>(ncol) * g <
                      static_cast<int64_t>(sms) * kTreeBlock)
    g *= 2;
  return g;
}

int blocks(int64_t threads, int block = kBlock) {
  return static_cast<int>((threads + block - 1) / block);
}

using ProbeFn = void (*)(const float*, const uint32_t*, const uint32_t*,
                         float*, int, int, int, int);

// The stream kernel: 2 columns a thread with the rounds unrolled, or the
// generic one.
ProbeFn stream_fn(bool unrolled) {
  return unrolled ? stream_kernel<2, kStreamRounds> : stream_kernel<1, 0>;
}

// registers, local bytes (stack frame and spills) and resident threads per
// SM (the occupancy calculator at `block` threads) of kernel k into out[0..2]
int kernel_info(const void* k, int block, int* out) {
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, k);
  int nb = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, block, 0);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = nb * block;
  return static_cast<int>(e);
}

bool probe_args_ok(int nc, int ncol, int rounds, int copies) {
  return nc >= 1 && nc <= kMaxNc && ncol >= 1 && rounds >= 0 && copies >= 1;
}

}  // namespace

// merge and stream: x f32 [nc, ncol], h1 and h2 int32 [nc, ncol] (the
// [NC, F, CT] arrays with F x CT flattened), out f32 [copies, ncol]; every
// copy computes the same columns. Return cudaGetLastError().
extern "C" int probe_merge_launch(const void* x, const void* h1,
                                  const void* h2, void* out, int nc, int ncol,
                                  int rounds, int copies, void* stream) {
  if (!probe_args_ok(nc, ncol, rounds, copies))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int tc = 32 / kMergeLanes, cp = kMergeBlock / 32;
  const dim3 grid((ncol + tc - 1) / tc, (copies + cp - 1) / cp);
  merge_kernel<<<grid, kMergeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<float*>(out), nc, ncol,
      rounds, copies);
  return static_cast<int>(cudaGetLastError());
}

// stream: 2 columns a thread where there are 8 rounds, ncol is even and
// every pointer is 8-byte aligned, else the generic kernel.
extern "C" int probe_stream_launch(const void* x, const void* h1,
                                   const void* h2, void* out, int nc,
                                   int ncol, int rounds, int copies,
                                   void* stream) {
  if (!probe_args_ok(nc, ncol, rounds, copies))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const bool wide = rounds == kStreamRounds && ncol % 2 == 0 &&
                    (addr(x) | addr(h1) | addr(h2) | addr(out)) % 8 == 0;
  const int vec = wide ? 2 : 1;
  const ProbeFn fn = stream_fn(wide);
  fn<<<blocks(static_cast<int64_t>(copies) * (ncol / vec)), kBlock, 0,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<float*>(out), nc, ncol,
      rounds, copies);
  return static_cast<int>(cudaGetLastError());
}

// The registers, local bytes and resident threads per SM of the merge
// kernel, into out[0..2].
extern "C" int probe_merge_info(int* out) {
  return kernel_info(reinterpret_cast<const void*>(merge_kernel), kMergeBlock,
                     out);
}

// The same for the stream kernel, the one of 2 columns a thread with its
// rounds unrolled if `unrolled`, else the generic one.
extern "C" int probe_stream_info(int unrolled, int* out) {
  return kernel_info(reinterpret_cast<const void*>(stream_fn(unrolled != 0)),
                     kBlock, out);
}

// The issue-rate chain of `kind` (IssueKind) over `nblocks` blocks of 128
// threads, `iters` iterations of 16 steps of 8 chains: in uint32 [8], out
// uint32 [nblocks * 128].
extern "C" int probe_issue_launch(int kind, const void* in, void* out,
                                  int nblocks, int iters, void* stream) {
  if (nblocks < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto i = static_cast<const uint32_t*>(in);
  const auto o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  void (*fn)(const uint32_t*, uint32_t*, int) = nullptr;
  switch (kind) {
    case kFadd: fn = issue_kernel<kFadd>; break;
    case kFmnmx: fn = issue_kernel<kFmnmx>; break;
    case kFsetpFsel: fn = issue_kernel<kFsetpFsel>; break;
    case kIsetpSel: fn = issue_kernel<kIsetpSel>; break;
    case kShfl: fn = issue_kernel<kShfl>; break;
    case kIadd3: fn = issue_kernel<kIadd3>; break;
    case kLop3: fn = issue_kernel<kLop3>; break;
    case kImad: fn = issue_kernel<kImad>; break;
    case kFaddFmnmx: fn = issue_kernel<kFaddFmnmx>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  fn<<<nblocks, kBlock, 0, st>>>(i, o, iters);
  return static_cast<int>(cudaGetLastError());
}

// treepop: x f32 [nc, ncol], h int32 [nc, ncol], out f32 [ncol], out_h
// int32 [ncol]; variant 0 argmax, 1 reshape_pair, 2 halves, 3 concat; lanes
// 1, 2, 4 or 8 a column, or 0 for `probe_treepop_lanes(ncol)`; with
// `guarded` the outputs are the kernel's if x[0] < 1e9, else zeros. Returns
// cudaGetLastError().
extern "C" int probe_treepop_launch(const void* x, const void* h, void* out,
                                    void* out_h, int nc, int ncol,
                                    int variant, int guarded, int lanes,
                                    void* stream) {
  if (nc < 1 || nc > kMaxNc || ncol < 1 || lanes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 && (lanes = tree_lanes(ncol)) == 0)
    return static_cast<int>(cudaGetLastError());
  const TreeFn fn = tree_fn(variant, lanes);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = kTreeBlock / lanes;  // columns a block
  fn<<<(ncol + cols - 1) / cols, kTreeBlock, 0,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(h),
      static_cast<float*>(out), static_cast<int32_t*>(out_h), ncol, guarded,
      tree_rows(variant, nc));
  return static_cast<int>(cudaGetLastError());
}

// The lanes a column `probe_treepop_launch` takes for ncol columns when
// given 0, on the current device; 0 if the device query fails.
extern "C" int probe_treepop_lanes(int ncol) { return tree_lanes(ncol); }

// The registers, local bytes and resident threads per SM of the tree-pop
// kernel of `variant` at `lanes` lanes a column, into out[0..2].
extern "C" int probe_treepop_info(int variant, int lanes, int* out) {
  const TreeFn fn = tree_fn(variant, lanes);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_info(reinterpret_cast<const void*>(fn), kTreeBlock, out);
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
