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
// Treepop at the probe's shapes (1024 to 4096 columns) is a few thousand
// threads and measures launch latency more than anything else; it checks
// index order, not speed.
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

template <int V>
__global__ void __launch_bounds__(kBlock) treepop_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ h,
    float* __restrict__ out, int32_t* __restrict__ out_h, int nc, int ncol,
    int guarded) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  // run_when's pl.when: every column reads the first element
  if (guarded && !(x[0] < 1e9f)) return;
  int n = V == kConcat && nc > kConcatN ? kConcatN : nc;
  if (V == kArgmax) {  // first maximum in index order
    float best = x[col];
    int32_t bh = h[col];
    for (int i = 1; i < n; ++i) {
      const float v = x[static_cast<size_t>(i) * ncol + col];
      if (v > best) {
        best = v;
        bh = h[static_cast<size_t>(i) * ncol + col];
      }
    }
    out[col] = best;
    out_h[col] = bh;
    return;
  }
  float v[kMaxNc];
  int32_t p[kMaxNc];
  for (int i = 0; i < n; ++i) {
    v[i] = x[static_cast<size_t>(i) * ncol + col];
    p[i] = h[static_cast<size_t>(i) * ncol + col];
  }
  // each level writes its survivors to the front of the arrays; a survivor
  // i reads only entries at indices >= i, none of them written yet
  while (n > 1) {
    const int m = n / 2;
    for (int i = 0; i < m; ++i) {
      // halves pairs i with i + m, the others 2i with 2i + 1; the second
      // of a pair wins only if strictly greater
      const int a = V == kHalves ? i : 2 * i;
      const int b = V == kHalves ? i + m : 2 * i + 1;
      const bool tk = v[b] > v[a];
      v[i] = tk ? v[b] : v[a];
      p[i] = tk ? p[b] : p[a];
    }
    if (V == kConcat && 2 * m < n) {  // carry the odd one out, last
      v[m] = v[2 * m];
      p[m] = p[2 * m];
      n = m + 1;
    } else {  // reshape_pair and halves drop an odd last entry
      n = m;
    }
  }
  out[col] = v[0];
  out_h[col] = p[0];
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
// int32 [ncol]; variant 0 argmax, 1 reshape_pair, 2 halves, 3 concat; with
// `guarded` the outputs are written only if x[0] < 1e9. Returns
// cudaGetLastError().
extern "C" int probe_treepop_launch(const void* x, const void* h, void* out,
                                    void* out_h, int nc, int ncol,
                                    int variant, int guarded, void* stream) {
  if (nc < 1 || nc > kMaxNc || ncol < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto xs = static_cast<const float*>(x);
  const auto hs = static_cast<const int32_t*>(h);
  const auto o = static_cast<float*>(out);
  const auto oh = static_cast<int32_t*>(out_h);
  const auto st = static_cast<cudaStream_t>(stream);
  const int nb = blocks(ncol);
  switch (variant) {
    case kArgmax:
      treepop_kernel<kArgmax><<<nb, kBlock, 0, st>>>(xs, hs, o, oh, nc, ncol,
                                                     guarded);
      break;
    case kReshapePair:
      treepop_kernel<kReshapePair><<<nb, kBlock, 0, st>>>(xs, hs, o, oh, nc,
                                                          ncol, guarded);
      break;
    case kHalves:
      treepop_kernel<kHalves><<<nb, kBlock, 0, st>>>(xs, hs, o, oh, nc, ncol,
                                                     guarded);
      break;
    case kConcat:
      treepop_kernel<kConcat><<<nb, kBlock, 0, st>>>(xs, hs, o, oh, nc, ncol,
                                                     guarded);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
