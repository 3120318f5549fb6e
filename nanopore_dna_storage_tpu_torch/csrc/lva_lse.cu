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
// So each (read, window row, CRF destination, conv state) loads all of its
// nq * L candidates (the stay row and one move row per CRF predecessor, as
// lva_acs.cu addresses them) and runs L rounds over them: one thread at
// L <= 8, a group of lanes of a warp at L <= 16 and L <= 64.
//
// What bounds it on this card. The step must read every slot of the
// previous rows and write the outputs (0.158 ms at m=11 L=8 B=4 on an
// H100), and since a class stays whole until it is popped, a grouping of
// the candidates by (h1, h2) gives the same rounds in about n log n
// operations a destination (chip_smoke.py counts both on the step's data:
// merge_roofline.lse_bound, acs_lse_grouped_needed). This kernel runs the
// flat merge instead: at m=11 L=8 a flip destination has 64 candidates, so
// every round is a pop over 64 scores and a class pass over 64 hash pairs,
// L rounds per destination (acs_lse_needed: 0.206 ms at that step by
// operations), which needs no sort across a destination's lanes and keeps
// every candidate where it was loaded. The first form of this kernel held the candidates in arrays
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
//
// The L <= 16 and L <= 64 buckets (the paper's m=8 list size is 64, its
// best m=8 reading cost is at 16) give each destination G adjacent lanes of
// a warp (kLanes16 = 4, kLanes64 = 32), the block 128 threads on 128 / G
// neighbouring conv states of one (read, window row, f). The candidates lie
// at padded index q * LB + slot (LB = 16 or 64, slots past L -inf, 2 rows
// for a flop and 8 for a flip as above) and lane g holds the contiguous
// N = 8 * LB / G of them from g * N (32 at L <= 16, 16 at L <= 64), so
// ascending lanes hold ascending flat indices: its scores in registers,
// its (h1, h2) pairs in its row of shared memory. Each round:
// - each lane's tree pop (tree_max), then shuffle steps on (score, padded
//   index) across the group, the lower index winning a tie (group_max);
// - the winner's hashes read by its owner lane and shuffled to the group;
// - each lane's member mask, the hashes read at compile-time indices;
// - a ballot over "a member other than the winner": if no lane has one,
//   the sum is 1.0f and the output best + 0.0f, with no log call;
//   otherwise the f32 sum is chained from 0.0f through the member lanes
//   in ascending order, each adding its terms in ascending index onto the
//   sum of the lanes before, as the flat loop adds them;
// - the knockout by select on the mask; the round's result staged in
//   shared memory, written as whole rows once the block is done.
// No array is indexed at run time but the shared-memory rows, so neither
// build has a stack frame. On an H100 80GB HBM3 at 700 W (PERF.md, in
// turns with the flat form of the first port, whose candidates lay in
// local memory: 1.5-6 KB a thread): m=11 L=12 B=4 8.36 -> 3.64 ms; m=8
// L=64 B=4 30.5 -> 5.61 ms. Hashes in registers were slower at both
// sizes (L <= 16: 148 registers, 384 threads per SM, 5.04 ms; L <= 64:
// 82, 640, 8.76 ms), as were 8 lanes at L <= 16 (4.32 ms), 16 lanes with
// the hashes in registers at L <= 64 (7.04 ms) and every candidate in
// shared memory (4.92, 7.76 ms).
//
// Exactness: each candidate score is one f32 add, prev + transition; each
// term is exp of the f32 difference csc - best, evaluated in double and
// rounded once to float; the sum adds the terms in f32 from 0.0f in
// ascending flat index; the output is best + (float)log((double)sum). The
// build passes --fmad=false and no fast-math flag, so exp and log are the
// libdevice functions that PyTorch's CUDA exp and log call on doubles.

#include "lva_common.cuh"

namespace {

// the lane buckets: kLanes16 adjacent lanes of a warp a destination at
// L <= 16, kLanes64 at L <= 64, kLaneBlock threads a block
constexpr int kLanes16 = 4;
constexpr int kLanes64 = 32;
constexpr int kLaneBlock = 128;

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

// The live members of the class (a, b) among a lane's N candidates, bit i
// for candidate i: one byte of bits at a time, each its own chain of eight.
// The scores are cs in registers, the hashes the pairs wh in this thread's
// row of shared memory.
template <int N, int A, int AW>
__device__ __forceinline__ uint32_t member_mask(const float (&cs)[A],
                                                const uint2 (&wh)[AW],
                                                uint32_t a, uint32_t b) {
  uint32_t m = 0;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += 8) {
    uint32_t r8 = 0;
#pragma unroll
    for (int i = i0; i < i0 + 8 && i < N; ++i) {
      const uint2 h = wh[i];
      const bool member = h.x == a && cs[i] > -INFINITY && h.y == b;
      r8 |= member ? 1u << (i - i0) : 0u;
    }
    m |= r8 << i0;
  }
  return m;
}

// The L <= LB merge (LB = 16 or 64) of one destination over its G adjacent
// lanes; this is lane l of the destination at tile column t. The nq <= NQ
// candidate rows (8 for a flip, 2 for a flop) are laid out at padded index
// q * LB + slot, slots past L -inf, and lane l holds the N = NQ * LB / G
// of them at [l * N, (l + 1) * N), so ascending lanes hold ascending flat
// indices q * L + slot: their scores in cs (registers), their (h1, h2)
// pairs in wh, the thread's row of shared memory, which the class pass
// reads at compile-time indices and the winner's owner at a run-time one.
// Row q reads the plane of position pos - 1 from row_base[q] + (q == 0 ? s
// : pred) (the stay row's base points into the next plane) and adds
// row_tr[q]. Writes the popped rounds into the block's staging arrays st
// and their count into st.n[t] (-1 for a destination that is not live).
// Every lane of the warp calls it.
template <int NQ, int LB, int G, typename SelT, int A, int AW>
__device__ __forceinline__ void merge_lanes(
    float (&cs)[A], uint2 (&wh)[AW],
    const float* __restrict__ q_sc, const uint32_t* __restrict__ q_h1,
    const uint32_t* __restrict__ q_h2, const uint32_t* row_base,
    const float* row_tr, int nq, int c, int s, uint32_t pred, int shift,
    uint32_t nb, bool live, int l, int t, int L, int C, int sel_shift,
    Staged<LB, kLaneBlock / G, SelT>& st) {
  constexpr int N = NQ * LB / G;  // candidates a lane
  static_assert(N >= 1 && N <= 32 && N <= A && N <= AW,
                "a lane's mask is 32 bits");
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int p = l * N + i;
    const int q = p / LB, j = p % LB;
    float x = -INFINITY;
    uint32_t x1 = 0, x2 = 0;
    if (live && q < nq && (q == 0 || c >= 0) && j < L) {
      const uint32_t at = row_base[q] + (q == 0 ? s : pred) + j * C;
      x = __ldg(q_sc + at) + row_tr[q];
      x1 = __ldg(q_h1 + at);
      x2 = __ldg(q_h2 + at);
      if (q != 0) {
        x1 = hash_update(x1, shift, nb, kP1);
        x2 = hash_update(x2, shift, nb, kP2);
      }
    }
    cs[i] = x;
    wh[i] = make_uint2(x1, x2);
  }
  // this group's lanes in the warp's ballots, shifted down to bit 0
  const int first = (threadIdx.x & 31) & ~(G - 1);
  const unsigned lanes = G == 32 ? kFull : (1u << G) - 1;
  int popped = 0;  // rounds popped, the same in every lane of the group
#pragma unroll 1
  for (int r = 0; r < L; ++r) {
    // the lane's best (a tree), then the group's
    float best;
    int k;
    tree_max<0, N>(cs, best, k);
    k += l * N;
    // the lowest index of the maximum, in every lane of the group
    group_best<G, G>(best, k);
    const bool pop = best > -INFINITY;
    // once nothing is left, every later round pops nothing too
    if (!__any_sync(kFull, pop)) break;
    const int owner = k / N, kk = k % N;
    const uint2 wk = wh[kk];
    const uint32_t a = __shfl_sync(kFull, wk.x, owner, G);
    const uint32_t bb = __shfl_sync(kFull, wk.y, owner, G);
    const uint32_t mm = member_mask<N>(cs, wh, a, bb);
    const uint32_t own = l == owner ? 1u << kk : 0u;
    const uint32_t other = mm & ~own;
    // the term of the lane's first member other than the winner, in
    // parallel over the lanes; the winner's own term is exp(0.0) = 1.0
    int i1 = -1;
    float t1 = 0.0f;
    if (other) {
      i1 = __ffs(other) - 1;
      t1 = static_cast<float>(
          ::exp(static_cast<double>(pick<0, N>(cs, i1) - best)));
    }
    const unsigned extra = (__ballot_sync(kFull, other != 0) >> first) & lanes;
    unsigned todo = (__ballot_sync(kFull, mm != 0) >> first) & lanes;
    // a class of the winner alone sums to 1.0 exactly; otherwise the sum
    // runs from 0.0f through the member lanes in ascending order, each
    // adding its terms in ascending index onto the sum of the lanes before
    float sum = 1.0f;
    if (extra) {
      sum = 0.0f;
    } else {
      todo = 0;
    }
    while (__any_sync(kFull, todo != 0)) {
      const int j = todo ? __ffs(todo) - 1 : 0;
      if (todo && l == j) {
        for (uint32_t rest = mm; rest; rest &= rest - 1) {
          const int i = __ffs(rest) - 1;
          const float term =
              (own >> i) & 1u ? 1.0f
              : i == i1       ? t1
                              : static_cast<float>(::exp(static_cast<double>(
                                    pick<0, N>(cs, i) - best)));
          sum += term;
        }
      }
      sum = __shfl_sync(kFull, sum, j, G);
      todo &= todo - 1;
    }
    // log(1.0) is 0.0: the lone winner's output is best + 0.0f
    const float val =
        best + (extra ? static_cast<float>(::log(static_cast<double>(sum)))
                      : 0.0f);
#pragma unroll
    for (int i = 0; i < N; ++i) cs[i] = (mm >> i) & 1u ? -INFINITY : cs[i];
    if (pop && l == 0) {
      st.sc[r][t] = val;
      st.h1[r][t] = a;
      st.h2[r][t] = bb;
      st.sel[r][t] = SelT((k / LB) * sel_shift + k % LB);
    }
    popped += pop;
  }
  if (l == 0) st.n[t] = live ? popped : -1;
}

// The L <= 8 bucket: one thread a destination.
template <typename SelT>
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

  __shared__ uint32_t row_base[kNq];
  __shared__ float row_tr[kNq];
  __shared__ int row_count;
  row_table(stay_tr, move_tr, qmap, b, f, LC, row_base, row_tr, row_count);
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
  // every thread of a block has the same f, so the branch is uniform
  if (nq == 2)
    merge_regs<2, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                        row_base, row_tr, nq, c, s, pred, shift, nb, row, sC,
                        L, C, sel_shift);
  else
    merge_regs<kNq, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                          row_base, row_tr, nq, c, s, pred, shift, nb, row,
                          sC, L, C, sel_shift);
}

// The L <= LB bucket for LB = 16 and 64: G lanes a destination, a block of
// kLaneBlock threads on kLaneBlock / G neighbouring conv states of one
// (read, window row, f). Arguments as lva_lse_kernel's.
template <int LB, int G, typename SelT>
__global__ void __launch_bounds__(kLaneBlock) lva_lse_lanes_kernel(
    const float* __restrict__ p_sc, const uint32_t* __restrict__ p_h1,
    const uint32_t* __restrict__ p_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    void* __restrict__ sel_out, const float* __restrict__ stay_tr,
    const float* __restrict__ move_tr, const int32_t* __restrict__ start1,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ cstar,
    const int32_t* __restrict__ nbits, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ pattern, const int32_t* __restrict__ qmap,
    int P, int L, int C, int W, int sel_shift) {
  constexpr int T = kLaneBlock / G;  // destinations (conv states) a block
  constexpr int NF = kNq * LB / G;   // a flip lane's candidates
  const int w = blockIdx.y / kNcrf;
  const int f = blockIdx.y % kNcrf;
  const int b = blockIdx.z;
  const size_t sC = static_cast<size_t>(C);
  const size_t LC = static_cast<size_t>(L) * sC;

  __shared__ uint32_t row_base[kNq];
  __shared__ float row_tr[kNq];
  __shared__ int row_count;
  // the popped rounds of the block's T destinations, and their counts
  __shared__ Staged<LB, T, SelT> st;
  row_table(stay_tr, move_tr, qmap, b, f, LC, row_base, row_tr, row_count);
  __syncthreads();

  const int s0 = blockIdx.x * T;
  const int pos = start1[b] + w;
  const Tile<T, kLaneBlock, SelT> tile{
      L, C - s0 < T ? C - s0 : T, s0, sC,
      // slot 0 of conv state s0 of this row in the prev and the stale buffer
      ((static_cast<size_t>(b) * P + pos) * kNcrf + f) * LC + s0,
      static_cast<SelT*>(sel_out) +
          ((static_cast<size_t>(b) * W + w) * kNcrf + f) * LC + s0};
  if (tile.edge(active[b], pos, valid, p_sc, p_h1, p_h2, s_sc, s_h1, s_h2,
                row_tr))
    return;

  const int l = threadIdx.x % G;  // this lane of its destination
  const int t = threadIdx.x / G;  // its destination's tile column
  const int s = s0 + t;
  const bool live =
      t < tile.cols && valid[static_cast<size_t>(pos) * sC + s];
  // moves: the emitted base is f % 4, and at most one conv candidate c
  // emits it; without one (c < 0) every move row is -inf
  const int pat = pattern[pos];
  const int kvar = pat != 0;
  const int shift = 1 + kvar;
  const uint32_t nb = live ? static_cast<uint32_t>(nbits[kvar * C + s]) : 0;
  const int c = live ? cstar[(pat * 4 + (f & 3)) * C + s] : -1;
  const uint32_t pred = static_cast<uint32_t>(((s << shift) + c) & (C - 1));
  const size_t plane =
      (static_cast<size_t>(b) * P + (pos - 1)) * kNcrf * LC;
  const int nq = row_count;
  // a thread's row of (h1, h2) pairs in shared memory, rows an odd number
  // of pairs apart, so that a warp's accesses to one index fall in
  // distinct banks
  __shared__ uint2 m_h[kLaneBlock][NF + 1];
  uint2(&wh)[NF + 1] = m_h[threadIdx.x];
  // every thread of a block has the same f, so the branch is uniform
  if (nq == 2) {
    float cs[2 * LB / G];
    merge_lanes<2, LB, G, SelT>(cs, wh, p_sc + plane, p_h1 + plane,
                                p_h2 + plane, row_base, row_tr, nq, c, s,
                                pred, shift, nb, live, l, t, L, C, sel_shift,
                                st);
  } else {
    float cs[NF];
    merge_lanes<kNq, LB, G, SelT>(cs, wh, p_sc + plane, p_h1 + plane,
                                  p_h2 + plane, row_base, row_tr, nq, c, s,
                                  pred, shift, nb, live, l, t, L, C,
                                  sel_shift, st);
  }
  __syncthreads();
  tile.write(st, s_sc, s_h1, s_h2);
}

using KernelFn = void (*)(const float*, const uint32_t*, const uint32_t*,
                          float*, uint32_t*, uint32_t*, void*, const float*,
                          const float*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, int, int, int, int,
                          int);

// A list-size bucket: its kernel, threads a block, lanes a destination
// (so threads / lanes destinations, conv states, a block) and the
// selection code's row stride.
struct Bucket {
  KernelFn kernel;
  int threads, lanes, sel_shift;
};

// The bucket of list size L: 8 and 16 with int8 selections, 64 with int16.
Bucket bucket(int L) {
  if (L <= 8) return {&lva_lse_kernel<int8_t>, kBlock, 1, 16};
  if (L <= 16)
    return {&lva_lse_lanes_kernel<16, kLanes16, int8_t>, kLaneBlock,
            kLanes16, 16};
  return {&lva_lse_lanes_kernel<64, kLanes64, int16_t>, kLaneBlock, kLanes64,
          64};
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
  const Bucket k = bucket(L);
  // a one-thread bucket's block shrinks to C threads at small C
  const int threads = k.lanes == 1 && C < k.threads ? C : k.threads;
  const int per_block = threads / k.lanes;
  const dim3 grid((C + per_block - 1) / per_block, W * kNcrf, B);
  k.kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_sc), static_cast<const uint32_t*>(p_h1),
      static_cast<const uint32_t*>(p_h2), static_cast<float*>(s_sc),
      static_cast<uint32_t*>(s_h1), static_cast<uint32_t*>(s_h2), sel,
      static_cast<const float*>(stay_tr), static_cast<const float*>(move_tr),
      static_cast<const int32_t*>(start1), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(cstar), static_cast<const int32_t*>(nbits),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pattern),
      static_cast<const int32_t*>(qmap), P, L, C, W, k.sel_shift);
  return static_cast<int>(cudaGetLastError());
}

// The registers, local memory (stack and spills, bytes) and resident threads
// per SM (the occupancy calculator, at the bucket's block size) of the
// kernel that runs list size L, into out[0..2].
extern "C" int lva_lse_info(int L, int* out) {
  if (L < 1 || L > 64) return static_cast<int>(cudaErrorInvalidValue);
  const Bucket k = bucket(L);
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, k.kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.kernel,
                                                      k.threads, 0);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = blocks * k.threads;
  return static_cast<int>(e);
}

extern "C" const char* lva_lse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
