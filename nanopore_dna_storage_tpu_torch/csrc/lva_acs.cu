// List-Viterbi ACS block step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nanopore_dna_storage_tpu/ops/lva_pallas.py
// `acs_block` / `_make_kernel.kernel` (pallas_call at lva_pallas.py:929):
// one signal block of the list-Viterbi over the beam window, for a batch of
// reads. The semantics are stated in ops/lva_acs.py, whose `acs_block_ref`
// is the plain PyTorch version this kernel is held against bit for bit.
//
// What bounds it on this card: integer and compare work in the suppression
// merge (L rounds over up to 8L candidates, each round a max scan plus a
// dual-hash knockout scan: ~16 L^2 compares per (read, row, CRF state,
// conv state)), and the selection writes, 8L bytes per (row, conv state):
// about 2.1 GB of int8 per read at m=11 L=8 over ~400 blocks. Score and
// hash traffic is 3 x 4 B x 8L loads of the stay and move rows plus 3 x 4 B
// x L stores per thread.
//
// What the design does about it: one thread per (read, window row, CRF
// destination, conv state), with neighbouring threads on neighbouring conv
// states, so stay-row loads, buffer stores and selection stores are
// coalesced; the move-row loads read predecessor (k*s + c) mod C, a stride-k
// pattern that stays within a few cache lines per warp. The TPU layout
// tricks (bit-reversed lanes, roll butterfly, MXU one-hot expansion,
// tournament merge) are not needed: Hopper has native gathers and uint32.
// The candidates live in a per-thread array (local memory, cached in L1);
// the list size is a template bucket (8, 16, 64) so every supported L runs.
// A K-way merge of the already sorted rows, and moving the candidates to
// registers or shared memory, are the obvious next steps.
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

__device__ __forceinline__ uint32_t hash_update(uint32_t h, int shift,
                                                uint32_t nb, uint32_t p) {
  uint32_t t = (h << shift) + nb;  // < 4p: three conditional subtracts
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  return t;
}

template <int LB, typename SelT>
__global__ void __launch_bounds__(kBlock) lva_acs_kernel(
    const float* __restrict__ p_sc, const uint32_t* __restrict__ p_h1,
    const uint32_t* __restrict__ p_h2, float* __restrict__ s_sc,
    uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
    SelT* __restrict__ sel, const float* __restrict__ stay_tr,
    const float* __restrict__ move_tr, const int32_t* __restrict__ start1,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ cstar,
    const int32_t* __restrict__ nbits, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ pattern, const int32_t* __restrict__ qmap,
    int P, int L, int C, int W, int sel_shift) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int w = blockIdx.y / kNcrf;
  const int f = blockIdx.y % kNcrf;
  const int b = blockIdx.z;
  const int pos = start1[b] + w;
  const size_t sC = static_cast<size_t>(C);
  const size_t LC = static_cast<size_t>(L) * sC;
  SelT* out_sel =
      sel + ((static_cast<size_t>(b) * W + w) * kNcrf + f) * LC + s;

  // inactive read or invalid state: the stale buffer keeps its value
  if (!active[b] || !valid[static_cast<size_t>(pos) * sC + s]) {
    for (int j = 0; j < L; ++j) out_sel[j * sC] = SelT(-1);
    return;
  }

  // the same offset addresses this row in the prev and the stale buffer
  const size_t row =
      ((static_cast<size_t>(b) * P + pos) * kNcrf + f) * LC + s;
  const float str = stay_tr[b * kNcrf + f];

  if (pos == 1) {  // trellis position 0: stay-only, slot 0 scored
    const float s0 = p_sc[row] + str;
    for (int j = 0; j < L; ++j) {
      s_sc[row + j * sC] = j == 0 ? s0 : -INFINITY;
      s_h1[row + j * sC] = p_h1[row + j * sC];
      s_h2[row + j * sC] = p_h2[row + j * sC];
      out_sel[j * sC] = SelT(j);
    }
    return;
  }

  float csc[kNq * LB];
  uint32_t ch1[kNq * LB];
  uint32_t ch2[kNq * LB];

  // row 0: stay in CRF state f at the same position and conv state
  for (int j = 0; j < L; ++j) {
    csc[j] = p_sc[row + j * sC] + str;
    ch1[j] = p_h1[row + j * sC];
    ch2[j] = p_h2[row + j * sC];
  }

  // rows 1..: moves from CRF predecessor g at the previous position. The
  // emitted base is f % 4, and at most one conv candidate c emits it.
  const int pat = pattern[pos];
  const int kvar = pat != 0;
  const int shift = 1 + kvar;
  const uint32_t nb = static_cast<uint32_t>(nbits[kvar * C + s]);
  const int c = cstar[(pat * 4 + (f & 3)) * C + s];
  const int pred = ((s << shift) + c) & (C - 1);
  int nq = 1;
  for (int q = 1; q < kNq; ++q) {
    const int g = qmap[f * kNq + q];
    if (g < 0) break;
    const int base = q * L;
    if (c < 0) {
      for (int j = 0; j < L; ++j) {
        csc[base + j] = -INFINITY;
        ch1[base + j] = 0;
        ch2[base + j] = 0;
      }
    } else {
      const size_t src =
          ((static_cast<size_t>(b) * P + (pos - 1)) * kNcrf + g) * LC + pred;
      const float mtr = move_tr[(b * kNcrf + f) * kNcrf + g];
      for (int j = 0; j < L; ++j) {
        csc[base + j] = p_sc[src + j * sC] + mtr;
        ch1[base + j] = hash_update(p_h1[src + j * sC], shift, nb, kP1);
        ch2[base + j] = hash_update(p_h2[src + j * sC], shift, nb, kP2);
      }
    }
    nq = q + 1;
  }

  // suppression merge: pop the highest score (strict >, so the lowest flat
  // index wins ties), then knock out its whole (h1, h2) class
  const int n = nq * L;
  int r = 0;
  for (; r < L; ++r) {
    float best = -INFINITY;
    int bi = -1;
    for (int i = 0; i < n; ++i) {
      if (csc[i] > best) {
        best = csc[i];
        bi = i;
      }
    }
    if (bi < 0) break;
    const uint32_t h1 = ch1[bi];
    const uint32_t h2 = ch2[bi];
    s_sc[row + r * sC] = best;
    s_h1[row + r * sC] = h1;
    s_h2[row + r * sC] = h2;
    out_sel[r * sC] = SelT((bi / L) * sel_shift + bi % L);
    for (int i = 0; i < n; ++i) {
      if (ch1[i] == h1 && ch2[i] == h2) csc[i] = -INFINITY;
    }
  }
  for (; r < L; ++r) {  // nothing left to pop
    s_sc[row + r * sC] = -INFINITY;
    s_h1[row + r * sC] = 0;
    s_h2[row + r * sC] = 0;
    out_sel[r * sC] = SelT(-1);
  }
}

template <int LB, typename SelT>
void launch(const void* const* a, int B, int P, int L, int C, int W,
            int sel_shift, cudaStream_t stream) {
  const int threads = C < kBlock ? C : kBlock;
  const dim3 grid((C + threads - 1) / threads, W * kNcrf, B);
  lva_acs_kernel<LB, SelT><<<grid, threads, 0, stream>>>(
      static_cast<const float*>(a[0]), static_cast<const uint32_t*>(a[1]),
      static_cast<const uint32_t*>(a[2]),
      static_cast<float*>(const_cast<void*>(a[3])),
      static_cast<uint32_t*>(const_cast<void*>(a[4])),
      static_cast<uint32_t*>(const_cast<void*>(a[5])),
      static_cast<SelT*>(const_cast<void*>(a[6])),
      static_cast<const float*>(a[7]), static_cast<const float*>(a[8]),
      static_cast<const int32_t*>(a[9]), static_cast<const uint8_t*>(a[10]),
      static_cast<const int32_t*>(a[11]), static_cast<const int32_t*>(a[12]),
      static_cast<const uint8_t*>(a[13]), static_cast<const int32_t*>(a[14]),
      static_cast<const int32_t*>(a[15]), P, L, C, W, sel_shift);
}

}  // namespace

// Launch one block step on `stream`. Buffers [B, P, 8, L, C] (f32 scores,
// int32 hashes), selections [B, W, 8L, C] (int8 for L <= 16, else int16),
// stay_tr [B, 8], move_tr [B, 8, 8], start1 int32 [B], active bool [B],
// cstar int32 [4, 4, C], nbits int32 [2, C], valid uint8 [P, C],
// pattern int32 [P], qmap int32 [8, 8]. Returns cudaGetLastError().
extern "C" int lva_acs_launch(
    const void* p_sc, const void* p_h1, const void* p_h2, void* s_sc,
    void* s_h1, void* s_h2, void* sel, const void* stay_tr,
    const void* move_tr, const void* start1, const void* active,
    const void* cstar, const void* nbits, const void* valid,
    const void* pattern, const void* qmap, int B, int P, int L, int C, int W,
    void* stream) {
  const void* a[16] = {p_sc, p_h1, p_h2, s_sc, s_h1, s_h2, sel, stay_tr,
                       move_tr, start1, active, cstar, nbits, valid,
                       pattern, qmap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > 64 || C < 1 || B < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 8)
    launch<8, int8_t>(a, B, P, L, C, W, 16, st);
  else if (L <= 16)
    launch<16, int8_t>(a, B, P, L, C, W, 16, st);
  else
    launch<64, int16_t>(a, B, P, L, C, W, 64, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lva_acs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
