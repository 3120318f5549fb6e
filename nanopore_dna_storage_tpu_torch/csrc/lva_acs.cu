// List-Viterbi ACS block step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nanopore_dna_storage_tpu/ops/lva_pallas.py
// `acs_block` / `_make_kernel.kernel` (pallas_call at lva_pallas.py:929):
// one signal block of the list-Viterbi over the beam window, for a batch of
// reads. The semantics are stated in ops/lva_acs.py, whose `acs_block_ref`
// is the plain PyTorch version this kernel is held against bit for bit.
//
// K-way merge. The candidates of one (read, window row, CRF destination f,
// conv state s) are up to 8 rows of L, the stay row and one move row per CRF
// predecessor g, and every row is already sorted: a row of the previous
// buffer is a merge's output (or the initial or position-0 buffer), and a
// candidate row is that plus one constant transition score. So the kernel
// keeps one head per row and pops the highest (strict `>`, rows in
// ascending q, slots in order within a row: among equal scores the lowest
// flat index `q*L + slot` wins, as in the reference's scan); a head whose
// (h1, h2) was already emitted is dropped, which is what the reference's
// knockout does to it. A head is read from the previous buffer only when its
// row reaches it, and its score add and hash update happen at that load.
// The precondition, that scores in a (position, f, conv state) row of `prev`
// do not increase with slot, holds for every buffer the decoder makes
// (tests/test_torch_acs.py checks it over whole decodes, chip_smoke.py on
// the card's buffers).
//
// What bounds it on this card. The bytes: at m=11 L=8 B=4 (the main path's
// launch in chip_smoke.py) one step must move 418 MB on its data
// (merge_roofline.acs_needed_bytes: each previous-buffer slot the merge
// reaches, once, the W rows written and the int8 selections), 0.125 ms at
// 3.35 TB/s, while the operations the merge needs (acs_needed_ops: a first
// argmax over the heads per round, the pair checks, the head loads' adds
// and hash updates) take 0.026 ms at the FP32 lane peak. On an H100 80GB
// HBM3 at 700 W the kernel takes 0.40-0.41 ms there, about 30% of that
// bound (PERF.md). What holds it above, as far as can be told without
// profiler counters: each pop's load depends on the pop before it, and the
// lanes of a warp pop different rows, so a warp's load touches several
// rows' sectors and uses part of each. The flat scan it replaced (L rounds
// of a max scan and a dual-hash knockout over all 8L candidates, held in
// local memory at 1,280 threads per SM) took about 8x as long at B=4.
//
// What the design does about it: one thread per (read, window row, CRF
// destination, conv state), neighbouring threads on neighbouring conv states,
// so stay-row loads are coalesced; move rows read predecessor (k*s + c) mod
// C, a stride-k pattern within a few cache lines per warp. The heads (score
// and two hashes of up to 8 rows, their slots packed one byte a row) and,
// at L <= 8, the emitted pairs live in registers: every loop over rows,
// rounds and emitted pairs is unrolled to its bucket (2 or 8 rows, a list
// size of 8) and predicated on the runtime L, so nothing is indexed at run
// time. Each round's outputs are stored when the round ends, when every
// thread of a warp is on the same slot, so the stores stay coalesced and
// hold no registers. That keeps the kernel at 72 registers with no stack,
// 7 blocks of 128 threads (896) per SM, which __launch_bounds__ pins: the
// loads' latency is hidden by residency. The row table (each row's offset
// and transition score) is the same for a whole block and sits in shared
// memory. The 16 and 64 buckets keep their emitted pairs in local memory;
// they only need to be exact (chip_smoke.py holds the 16 bucket at L = 12,
// the goldens the 64 bucket at L = 34 and 64). The TPU layout tricks (bit-reversed lanes,
// roll butterfly, MXU one-hot expansion, tournament merge) are not needed:
// Hopper has native gathers and uint32.
//
// Exactness: each score is one f32 add, prev + transition, in that order;
// nothing else touches scores, and the build passes --fmad=false. Hashes
// are uint32 and stay below 2^30, so (h << 2) + 3 cannot wrap.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNcrf = 8;  // flip-flop CRF states
constexpr int kNq = 8;    // merge rows per destination: stay + up to 7 moves
constexpr uint32_t kP1 = 1073741789u;
constexpr uint32_t kP2 = 1073741783u;
constexpr int kBlock = 128;
// at least 7 blocks of kBlock resident per SM, so at most 72 registers a
// thread
constexpr int kMinBlocks = 7;

__device__ __forceinline__ uint32_t hash_update(uint32_t h, int shift,
                                                uint32_t nb, uint32_t p) {
  uint32_t t = (h << shift) + nb;  // < 4p: three conditional subtracts
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  return t;
}

// One head of a candidate row: the score of slot `at` of the previous buffer
// plus the row's transition score, and its hashes, updated for a move row.
__device__ __forceinline__ void load_head(
    const float* __restrict__ sc, const uint32_t* __restrict__ h1,
    const uint32_t* __restrict__ h2, uint32_t at, float tr, bool move,
    int shift, uint32_t nb, float& hs, uint32_t& ha, uint32_t& hb) {
  hs = __ldg(sc + at) + tr;
  ha = __ldg(h1 + at);
  hb = __ldg(h2 + at);
  if (move) {
    ha = hash_update(ha, shift, nb, kP1);
    hb = hash_update(hb, shift, nb, kP2);
  }
}

// The merge of one thread's nq <= NQ candidate rows into its L output
// slots: row q reads the plane of position pos - 1 from row_base[q] + (q ==
// 0 ? s : pred) (the stay row's base points into the next plane), and
// adds row_tr[q]. NQ is 8 for a flip destination and 2 for a flop, so the
// heads of a flop take no registers and no compares for rows it lacks.
template <int NQ, int LB, typename SelT>
__device__ __forceinline__ void merge(
    const float* __restrict__ q_sc, const uint32_t* __restrict__ q_h1,
    const uint32_t* __restrict__ q_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    SelT* __restrict__ out_sel, const uint32_t* row_base, const float* row_tr,
    int nq, int c, int s, uint32_t pred, int shift, uint32_t nb, size_t row,
    size_t sC, int L, int C, int sel_shift) {
  // the heads: score and hashes of each row's next candidate, -inf once the
  // row is exhausted; the head's slot in row q is byte q of `slots`
  float hs[NQ];
  uint32_t ha[NQ], hb[NQ];
  uint64_t slots = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    hs[q] = -INFINITY;
    ha[q] = hb[q] = 0;
    if (q < nq && (q == 0 || c >= 0))
      load_head(q_sc, q_h1, q_h2, row_base[q] + (q == 0 ? s : pred),
                row_tr[q], q != 0, shift, nb, hs[q], ha[q], hb[q]);
  }

  // the emitted pairs, against which each popped head is checked; the
  // loops over rounds and emitted pairs unroll fully at the register bucket
  // and run at run time in the larger ones. Each round ends with every
  // thread of a warp on the same slot, so its stores stay coalesced.
  uint32_t o1[LB], o2[LB];
  bool left = true;  // some head is finite
#pragma unroll (LB <= 8 ? LB : 1)
  for (int r = 0; r < LB; ++r) {
    if (r >= L) continue;
    float best = -INFINITY;
    uint32_t a = 0, bb = 0;
    int code = -1;
    while (left) {
      float top = -INFINITY;
      int bq = -1;
      uint32_t ta = 0, tb = 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (hs[q] > top) {
          top = hs[q];
          bq = q;
          ta = ha[q];
          tb = hb[q];
        }
      }
      if (bq < 0) {
        left = false;
        break;
      }
      // advance row bq: its next slot, or -inf past the end
      const int tj = static_cast<int>((slots >> (8 * bq)) & 0xff);
      slots += uint64_t{1} << (8 * bq);
      float xs = -INFINITY;
      uint32_t xa = 0, xb = 0;
      if (tj + 1 < L)
        load_head(q_sc, q_h1, q_h2,
                  row_base[bq] + (bq == 0 ? s : pred) + (tj + 1) * C,
                  row_tr[bq], bq != 0, shift, nb, xs, xa, xb);
      // a pair already emitted is dropped
      bool dup = false;
#pragma unroll (LB <= 8 ? LB : 1)
      for (int e = 0; e < (LB <= 8 ? LB : r); ++e) {
        if (e < r) dup |= o1[e] == ta && o2[e] == tb;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q == bq) {
          hs[q] = xs;
          ha[q] = xa;
          hb[q] = xb;
        }
      }
      if (!dup) {
        best = top;
        a = ta;
        bb = tb;
        code = bq * sel_shift + tj;
        break;
      }
    }
    o1[r] = a;
    o2[r] = bb;
    s_sc[row + r * sC] = best;
    s_h1[row + r * sC] = a;
    s_h2[row + r * sC] = bb;
    out_sel[r * sC] = SelT(code);
  }
}

template <int LB, typename SelT>
__global__ void __launch_bounds__(kBlock, kMinBlocks) lva_acs_kernel(
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
  // emits it; without one (c < 0) every move row starts exhausted
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
  // every thread of a block has the same f, so the branch is uniform
  const int nq = row_count;
  if (nq == 2)
    merge<2, LB, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel, row_base,
                       row_tr, nq, c, s, pred, shift, nb, row, sC, L, C,
                       sel_shift);
  else
    merge<kNq, LB, SelT>(q_sc, q_h1, q_h2, s_sc, s_h1, s_h2, out_sel,
                         row_base, row_tr, nq, c, s, pred, shift, nb, row, sC,
                         L, C, sel_shift);
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
  return L <= 8    ? &lva_acs_kernel<8, int8_t>
         : L <= 16 ? &lva_acs_kernel<16, int8_t>
                   : &lva_acs_kernel<64, int16_t>;
}

}  // namespace

// Launch one block step on `stream`. Buffers
// [B, P, 8, L, C] (f32 scores, int32 hashes), selections [B, W, 8L, C] (int8
// for L <= 16, else int16), stay_tr [B, 8], move_tr [B, 8, 8], start1 int32
// [B], active bool [B], cstar int32 [4, 4, C], nbits int32 [2, C], valid
// uint8 [P, C], pattern int32 [P], qmap int32 [8, 8]. Returns
// cudaGetLastError().
extern "C" int lva_acs_launch(
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
extern "C" int lva_acs_info(int L, int* out) {
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

extern "C" const char* lva_acs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
