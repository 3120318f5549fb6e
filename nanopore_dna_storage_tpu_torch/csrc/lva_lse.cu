// List-Viterbi ACS block step with logsumexp path combining, for Hopper
// (sm_90a).
//
// Replaces the logsumexp branch of the Pallas TPU kernel
// nanopore_dna_storage_tpu/ops/lva_pallas.py `_make_kernel` (`_supp_pass`,
// lva_pallas.py:614-646, with its candidate codes at :599-612 and the single
// pass it forces at :778-783), reached through `acs_block` (pallas_call at
// lva_pallas.py:929) when DecodeConfig.path_combine is "logsumexp" (the older
// binary's --use-logsumexp). The semantics are stated in ops/lva_acs.py,
// whose `acs_block_lse_ref` is the plain PyTorch version this kernel is held
// against bit for bit.
//
// Flat merge. Each round pops the highest candidate and writes best + log of
// the sum of exp(csc - best) over every live candidate with the popped
// (h1, h2), then knocks that class out. The sum needs the score of every
// duplicate, which the K-way kernel of lva_acs.cu never loads, and the
// outputs are not sorted in slot, which the K-way merge needs of its inputs.
// So one thread per (read, window row, CRF destination, conv state) loads all
// of its nq * L candidates (the stay row and one move row per CRF
// predecessor, as lva_acs.cu addresses them) and runs L rounds over them.
//
// What bounds it on this card: operations. At m=11 L=8 a flip destination
// has 64 candidates, so every round is a pop over 64 scores and a class pass
// over 64 hash pairs, L rounds per thread, while the bytes are one read of
// every slot of the previous rows and one write of the outputs, and the exp
// and log calls are few (chip_smoke.py counts all three on the step's data:
// merge_roofline.acs_lse_needed; 0.206 ms at B=4 on an H100, by
// operations). The first form of this kernel held the candidates in arrays
// indexed at run time, so in local memory (768 bytes a thread, 1,536
// threads per SM: ~155 MB of stacks across the card, more than the L2), and
// took 3.92 ms at B=4.
//
// The L <= 8 bucket (the headline's list size) keeps every candidate in
// registers: candidate q*8 + j is row q's slot j, slots j >= L and absent
// rows are the constant -inf, and every loop over candidates is unrolled, so
// no array is indexed at run time. The kernel is templated on the row count
// (8 for a flip destination, 2 for a flop: f = blockIdx.y % 8 makes the
// choice uniform per block), so a flop carries 16 candidates, not 64. Each
// round:
// - the pop is a tree over (score, index) pairs that pairs adjacent
//   candidates at every level and takes the right child only on a strict
//   `>`, so the left subtree always holds the lower indices and the tree
//   returns the lowest index of the maximum, as an ascending strict-`>` scan
//   does (ties and all -inf included; a strided halving tree would not, see
//   lva_pallas.py `_tree_pop`). It is 63 compare-selects at 64 candidates,
//   32-way independent at its first level, where the scan was a chain of 64;
// - the winner's hashes are read by a select tree on the index bits;
// - the class pass tests h1 == a && h2 == b && score > -inf with predicates
//   and records the members one byte a row, each byte its own chain of
//   eight (one chain of 64 ORs made the build spill);
// - a loop whose trip count is the thread's own member count adds the terms
//   in ascending index, each member's score read by a select tree on its
//   index bits; the winner's own term is exp(0.0) = 1.0 exactly, taken
//   without the call, so a warp runs the double exp only for lanes whose
//   class has another member;
// - the members are knocked out by select on the mask.
// That holds the L = 8 build at 252 registers with no stack frame and no
// spill, so 256 threads per SM. On an H100 80GB HBM3 at 700 W the step takes
// about 1.82 ms at B=4, 2.15x faster than the local-memory form, still ~11%
// of its bound (PERF.md). Its two halves, timed apart as variants of this
// kernel on one block's state: the candidate loads alone ~0.99 ms (192
// gathered loads a thread, latency-bound at 8 warps per SM: 0.73 ms at 384
// threads per SM), the merge alone on synthetic candidates ~1.19 ms. Holding
// h2 in shared memory (224 registers, the same 256 threads per SM) was
// slower, 2.09 ms; capped at 168 registers (384 threads per SM) it spilled.
// The L <= 16 and L <= 64 buckets keep the first form's flat merge, its
// arrays in local memory; they only need to be exact (chip_smoke.py holds
// the 16 bucket at L = 12).
//
// Exactness: each candidate score is one f32 add, prev + transition; each
// term is exp of the f32 difference csc - best, evaluated in double and
// rounded once to float; the sum adds the terms in f32 from 0.0f in
// ascending flat index; the output is best + (float)log((double)sum). The
// build passes --fmad=false and no fast-math flag, so exp and log are the
// libdevice functions that PyTorch's CUDA exp and log call on doubles.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNcrf = 8;  // flip-flop CRF states
constexpr int kNq = 8;    // merge rows per destination: stay + up to 7 moves
constexpr uint32_t kP1 = 1073741789u;
constexpr uint32_t kP2 = 1073741783u;
constexpr int kBlock = 128;

__device__ __forceinline__ uint32_t hash_update(uint32_t h, int shift,
                                                uint32_t nb, uint32_t p) {
  uint32_t t = (h << shift) + nb;  // < 4p: three conditional subtracts
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  return t;
}

// the register bucket's list size: candidate q * kLr + slot
constexpr int kLr = 8;

// The lowest-index maximum of cs[LO, LO + N) as (score, index): the two
// halves reduced depth first (few partial results live at once), then the
// right half taken only if strictly greater, so the left, lower indices win
// a tie. Every index is a compile-time constant.
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

// x[i] for a run-time i in [LO, LO + N), N a power of two and LO a multiple
// of it: a select tree on the bits of i, so that x stays in registers.
template <int LO, int N, typename T, int M>
__device__ __forceinline__ T pick(const T (&x)[M], int i) {
  if constexpr (N == 1) {
    return x[LO];
  } else {
    const T lo = pick<LO, N / 2>(x, i);
    const T hi = pick<LO + N / 2, N / 2>(x, i);
    return (i & (N / 2)) ? hi : lo;
  }
}

// The L <= 8 merge of one thread's nq <= NQ candidate rows into its L
// output slots, every candidate in registers: row q reads the plane of
// position pos - 1 from row_base[q] + (q == 0 ? s : pred) (the stay row's
// base points into the next plane) and adds row_tr[q]. NQ is 8 for a flip
// destination and 2 for a flop.
template <int NQ, typename SelT>
__device__ __forceinline__ void merge_regs(
    const float* __restrict__ q_sc, const uint32_t* __restrict__ q_h1,
    const uint32_t* __restrict__ q_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    SelT* __restrict__ out_sel, const uint32_t* row_base, const float* row_tr,
    int nq, int c, int s, uint32_t pred, int shift, uint32_t nb, size_t row,
    size_t sC, int L, int C, int sel_shift) {
  constexpr int N = NQ * kLr;
  // candidate q * kLr + j: a -inf candidate's hashes are never read, since
  // it can neither win a round nor join a sum
  float cs[N];
  uint32_t c1[N], c2[N];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const bool has = q < nq && (q == 0 || c >= 0);
    const uint32_t base = row_base[q] + (q == 0 ? s : pred);
    const float tr = row_tr[q];
#pragma unroll
    for (int j = 0; j < kLr; ++j) {
      const int i = q * kLr + j;
      cs[i] = -INFINITY;
      c1[i] = c2[i] = 0;
      if (has && j < L) {
        const uint32_t at = base + j * C;
        cs[i] = __ldg(q_sc + at) + tr;
        c1[i] = __ldg(q_h1 + at);
        c2[i] = __ldg(q_h2 + at);
        if (q != 0) {
          c1[i] = hash_update(c1[i], shift, nb, kP1);
          c2[i] = hash_update(c2[i], shift, nb, kP2);
        }
      }
    }
  }

  bool left = true;  // some candidate is finite
#pragma unroll 1
  for (int r = 0; r < L; ++r) {
    float best = -INFINITY;
    int bi = 0;
    if (left) {
      tree_max<0, N>(cs, best, bi);
      left = best > -INFINITY;
    }
    float val = -INFINITY;
    uint32_t a = 0, bb = 0;
    int code = -1;
    if (left) {
      a = pick<0, N>(c1, bi);
      bb = pick<0, N>(c2, bi);
      // the members of the popped class: one byte of bits a row, each
      // built by its own chain of eight, then the 64-bit mask of the flat
      // index
      uint32_t mq[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        uint32_t r8 = 0;
#pragma unroll
        for (int j = 0; j < kLr; ++j) {
          const int i = q * kLr + j;
          const bool member = c1[i] == a && cs[i] > -INFINITY && c2[i] == bb;
          r8 |= member ? 1u << j : 0u;
        }
        mq[q] = r8;
      }
      uint64_t m = 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        m |= static_cast<uint64_t>(mq[q]) << (kLr * q);
      // one term per member, in ascending index; the winner's is exp(0)
      float sum = 0.0f;
      for (uint64_t rest = m; rest; rest &= rest - 1) {
        const int i = __ffsll(static_cast<long long>(rest)) - 1;
        float t = 1.0f;
        if (i != bi)
          t = static_cast<float>(
              ::exp(static_cast<double>(pick<0, N>(cs, i) - best)));
        sum += t;
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        cs[i] = (mq[i / kLr] >> (i % kLr)) & 1u ? -INFINITY : cs[i];
      val = best + static_cast<float>(::log(static_cast<double>(sum)));
      code = (bi / kLr) * sel_shift + bi % kLr;
    }
    // every thread of a warp is on the same slot: the stores coalesce
    s_sc[row + r * sC] = val;
    s_h1[row + r * sC] = a;
    s_h2[row + r * sC] = bb;
    out_sel[r * sC] = SelT(code);
  }
}

// The L <= 16 and L <= 64 merge: the candidates, flat index q * L + slot,
// in arrays indexed at run time (local memory), L rounds of a max scan with
// strict `>` in ascending index and a class pass in the same order that
// adds one term per live member and knocks every member out.
template <int LB, typename SelT>
__device__ __forceinline__ void merge_flat(
    const float* __restrict__ q_sc, const uint32_t* __restrict__ q_h1,
    const uint32_t* __restrict__ q_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    SelT* __restrict__ out_sel, const uint32_t* row_base, const float* row_tr,
    int nq, int c, int s, uint32_t pred, int shift, uint32_t nb, size_t row,
    size_t sC, int L, int C, int sel_shift) {
  const int n = nq * L;
  float cs[kNq * LB];
  uint32_t c1[kNq * LB], c2[kNq * LB];
  for (int q = 0; q < nq; ++q) {
    const bool has = q == 0 || c >= 0;
    const uint32_t base = row_base[q] + (q == 0 ? s : pred);
    for (int j = 0; j < L; ++j) {
      const int i = q * L + j;
      cs[i] = -INFINITY;
      c1[i] = c2[i] = 0;
      if (has) {
        const uint32_t at = base + j * C;
        cs[i] = __ldg(q_sc + at) + row_tr[q];
        c1[i] = __ldg(q_h1 + at);
        c2[i] = __ldg(q_h2 + at);
        if (q != 0) {
          c1[i] = hash_update(c1[i], shift, nb, kP1);
          c2[i] = hash_update(c2[i], shift, nb, kP2);
        }
      }
    }
  }

  bool left = true;  // some candidate is finite
  for (int r = 0; r < L; ++r) {
    float best = -INFINITY;
    int bi = -1;
    if (left) {
      for (int i = 0; i < n; ++i) {
        if (cs[i] > best) {
          best = cs[i];
          bi = i;
        }
      }
      left = bi >= 0;
    }
    float val = -INFINITY;
    uint32_t a = 0, bb = 0;
    int code = -1;
    if (left) {
      a = c1[bi];
      bb = c2[bi];
      float sum = 0.0f;
      for (int i = 0; i < n; ++i) {
        if (c1[i] == a && c2[i] == bb) {
          if (cs[i] > -INFINITY)
            sum += static_cast<float>(
                ::exp(static_cast<double>(cs[i] - best)));
          cs[i] = -INFINITY;
        }
      }
      val = best + static_cast<float>(::log(static_cast<double>(sum)));
      code = (bi / L) * sel_shift + bi % L;
    }
    s_sc[row + r * sC] = val;
    s_h1[row + r * sC] = a;
    s_h2[row + r * sC] = bb;
    out_sel[r * sC] = SelT(code);
  }
}

template <int LB, typename SelT>
__global__ void __launch_bounds__(kBlock) lva_lse_kernel(
    const float* __restrict__ p_sc, const uint32_t* __restrict__ p_h1,
    const uint32_t* __restrict__ p_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    void* __restrict__ sel_out, const float* __restrict__ stay_tr,
    const float* __restrict__ move_tr, const int32_t* __restrict__ start1,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ cstar,
    const int32_t* __restrict__ nbits, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ pattern, const int32_t* __restrict__ qmap,
    int P, int L, int C, int W, int sel_shift) {
  const int w = blockIdx.y / kNcrf;
  const int f = blockIdx.y % kNcrf;
  const int b = blockIdx.z;
  const size_t sC = static_cast<size_t>(C);
  const size_t LC = static_cast<size_t>(L) * sC;

  // the row table of this block's (read, window row, f): row q's offset in
  // the plane of position pos - 1 (less the conv state) and its transition
  // score; the stay row lies in the next plane, at position pos
  __shared__ uint32_t row_base[kNq];
  __shared__ float row_tr[kNq];
  __shared__ int row_count;
  for (int q = threadIdx.x; q < kNq; q += blockDim.x) {
    const int g = q == 0 ? f : qmap[f * kNq + q];
    row_base[q] = static_cast<uint32_t>((q == 0 ? kNcrf + f : g < 0 ? 0 : g) *
                                        LC);
    row_tr[q] = q == 0 ? stay_tr[b * kNcrf + f]
                : g < 0 ? 0.0f
                        : move_tr[(b * kNcrf + f) * kNcrf + g];
  }
  if (threadIdx.x == 0) {
    int n = 1;
    while (n < kNq && qmap[f * kNq + n] >= 0) ++n;
    row_count = n;
  }
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int pos = start1[b] + w;
  SelT* out_sel = static_cast<SelT*>(sel_out) +
                  ((static_cast<size_t>(b) * W + w) * kNcrf + f) * LC + s;
  // the same offset addresses this row in the prev and the stale buffer
  const size_t row =
      ((static_cast<size_t>(b) * P + pos) * kNcrf + f) * LC + s;
  const bool live = active[b] && valid[static_cast<size_t>(pos) * sC + s];
  // an inactive read or an invalid state writes -1 selections and leaves
  // the stale buffer alone
  if (!live) {
    for (int j = 0; j < L; ++j) out_sel[j * sC] = SelT(-1);
    return;
  }
  // trellis position 0 (padded row 1) is stay-only: slot 0 takes the stay
  // score, the other slots -inf, hashes pass through and the code is the slot
  if (pos == 1) {
    const float s0 = p_sc[row] + row_tr[0];
    for (int j = 0; j < L; ++j) {
      s_sc[row + j * sC] = j == 0 ? s0 : -INFINITY;
      s_h1[row + j * sC] = p_h1[row + j * sC];
      s_h2[row + j * sC] = p_h2[row + j * sC];
      out_sel[j * sC] = SelT(j);
    }
    return;
  }

  // moves: the emitted base is f % 4, and at most one conv candidate c
  // emits it; without one (c < 0) every move row is -inf
  const int pat = pattern[pos];
  const int kvar = pat != 0;
  const int shift = 1 + kvar;
  const uint32_t nb = static_cast<uint32_t>(nbits[kvar * C + s]);
  const int c = cstar[(pat * 4 + (f & 3)) * C + s];
  const uint32_t pred = static_cast<uint32_t>(((s << shift) + c) & (C - 1));
  const size_t plane =
      (static_cast<size_t>(b) * P + (pos - 1)) * kNcrf * LC;
  const float* __restrict__ q_sc = p_sc + plane;
  const uint32_t* __restrict__ q_h1 = p_h1 + plane;
  const uint32_t* __restrict__ q_h2 = p_h2 + plane;
  const int nq = row_count;
  if constexpr (LB <= kLr) {
    // every thread of a block has the same f, so the branch is uniform
    if (nq == 2)
      merge_regs<2, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                          row_base, row_tr, nq, c, s, pred, shift, nb, row,
                          sC, L, C, sel_shift);
    else
      merge_regs<kNq, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                            row_base, row_tr, nq, c, s, pred, shift, nb, row,
                            sC, L, C, sel_shift);
  } else {
    merge_flat<LB, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                         row_base, row_tr, nq, c, s, pred, shift, nb, row, sC,
                         L, C, sel_shift);
  }
}

using KernelFn = void (*)(const float*, const uint32_t*, const uint32_t*,
                          float*, uint32_t*, uint32_t*, void*, const float*,
                          const float*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, int, int, int, int,
                          int);

// The kernel of one list-size bucket: 8 and 16 with int8 selections, 64
// with int16.
KernelFn bucket(int L) {
  return L <= 8    ? &lva_lse_kernel<8, int8_t>
         : L <= 16 ? &lva_lse_kernel<16, int8_t>
                   : &lva_lse_kernel<64, int16_t>;
}

}  // namespace

// Launch one block step on `stream`; arguments as lva_acs_launch's
// (lva_acs.cu). Returns cudaGetLastError().
extern "C" int lva_lse_launch(
    const void* p_sc, const void* p_h1, const void* p_h2, void* s_sc,
    void* s_h1, void* s_h2, void* sel, const void* stay_tr,
    const void* move_tr, const void* start1, const void* active,
    const void* cstar, const void* nbits, const void* valid,
    const void* pattern, const void* qmap, int B, int P, int L, int C, int W,
    void* stream) {
  if (L < 1 || L > 64 || C < 1 || B < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = C < kBlock ? C : kBlock;
  const dim3 grid((C + threads - 1) / threads, W * kNcrf, B);
  bucket(L)<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_sc), static_cast<const uint32_t*>(p_h1),
      static_cast<const uint32_t*>(p_h2), static_cast<float*>(s_sc),
      static_cast<uint32_t*>(s_h1), static_cast<uint32_t*>(s_h2), sel,
      static_cast<const float*>(stay_tr), static_cast<const float*>(move_tr),
      static_cast<const int32_t*>(start1), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(cstar), static_cast<const int32_t*>(nbits),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pattern),
      static_cast<const int32_t*>(qmap), P, L, C, W, L <= 16 ? 16 : 64);
  return static_cast<int>(cudaGetLastError());
}

// The registers, local memory (stack and spills, bytes) and resident threads
// per SM (the occupancy calculator, blocks of 128) of the kernel that runs
// list size L, into out[0..2].
extern "C" int lva_lse_info(int L, int* out) {
  if (L < 1 || L > 64) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = bucket(L);
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, k);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kBlock, 0);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = blocks * kBlock;
  return static_cast<int>(e);
}

extern "C" const char* lva_lse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
