// Device code that the two ACS block-step kernels share, lva_acs.cu (max
// combining) and lva_lse.cu (logsumexp combining): the layout constants,
// the hash update, the block's row table, the cross-lane best of a
// destination's lanes, and the lane buckets' tile: its staged rounds, the
// paths of an inactive read and of trellis position 0, and the write-back
// of the staged rounds as whole rows. ops/_build.py hashes this header
// into both libraries' names, so editing it rebuilds them.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNcrf = 8;  // flip-flop CRF states
constexpr int kNq = 8;    // merge rows per destination: stay + up to 7 moves
constexpr uint32_t kP1 = 1073741789u;
constexpr uint32_t kP2 = 1073741783u;
constexpr int kBlock = 128;  // threads a block of a one-thread bucket
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t hash_update(uint32_t h, int shift,
                                                uint32_t nb, uint32_t p) {
  uint32_t t = (h << shift) + nb;  // < 4p: three conditional subtracts
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  t = t >= p ? t - p : t;
  return t;
}

// The row table of a block's (read b, window row, CRF destination f), into
// shared memory: row q's offset in the plane of position pos - 1 (less the
// conv state) and its transition score, the stay row lying in the next
// plane, at position pos; and the number of rows (2 for a flop, 8 for a
// flip). The caller synchronises the block after it.
__device__ __forceinline__ void row_table(
    const float* __restrict__ stay_tr, const float* __restrict__ move_tr,
    const int32_t* __restrict__ qmap, int b, int f, size_t LC,
    uint32_t* row_base, float* row_tr, int& row_count) {
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
}

// (score, index) of a destination's best over its G adjacent lanes, from
// each lane's best: shuffle steps that take the other lane's pair on a
// higher score, or on an equal score with a lower index. Only the first
// SPAN lanes hold candidates (the others -inf); with SPAN < G lane 0's
// result is broadcast, else every lane ends with it.
template <int G, int SPAN>
__device__ __forceinline__ void group_best(float& v, int& k) {
#pragma unroll
  for (int off = 1; off < SPAN; off <<= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off, G);
    const int k2 = __shfl_xor_sync(kFull, k, off, G);
    if (v2 > v || (v2 == v && k2 < k)) {
      v = v2;
      k = k2;
    }
  }
  if (SPAN < G) {
    v = __shfl_sync(kFull, v, 0, G);
    k = __shfl_sync(kFull, k, 0, G);
  }
}

// The rounds a lane bucket's block stages for its T destinations (tile
// columns), up to LB each, and each destination's count (-1 for one that
// is not live), in shared memory.
template <int LB, int T, typename SelT>
struct Staged {
  float sc[LB][T];
  uint32_t h1[LB][T], h2[LB][T];
  SelT sel[LB][T];
  int n[T];
};

// A lane bucket's tile: T destinations (conv states s0 .. s0 + cols - 1)
// of one (read, window row, f) by L slots, walked by NT threads as whole
// rows (slot j, column x). `row` addresses slot 0 of conv state s0 in the
// prev and the stale buffer, `out_sel` its first selection.
template <int T, int NT, typename SelT>
struct Tile {
  int L, cols, s0;
  size_t sC, row;
  SelT* out_sel;

  // The tile of an inactive read, or of trellis position 0 (padded row 1),
  // written whole; false for any other tile. An inactive read writes -1
  // selections and leaves the stale buffer alone. Position 0 is stay-only:
  // slot 0 takes the stay score, the other slots -inf, hashes pass through
  // and the code is the slot; an invalid state selects -1.
  __device__ __forceinline__ bool edge(
      bool active, int pos, const uint8_t* __restrict__ valid,
      const float* __restrict__ p_sc, const uint32_t* __restrict__ p_h1,
      const uint32_t* __restrict__ p_h2, float* __restrict__ s_sc,
      uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2,
      const float* row_tr) const {
    if (!active) {
      for (int i = threadIdx.x; i < L * T; i += NT) {
        const int j = i / T, x = i % T;
        if (x < cols) out_sel[j * sC + x] = SelT(-1);
      }
      return true;
    }
    if (pos != 1) return false;
    for (int i = threadIdx.x; i < L * T; i += NT) {
      const int j = i / T, x = i % T;
      if (x >= cols) continue;
      const size_t o = j * sC + x;
      if (!valid[static_cast<size_t>(pos) * sC + s0 + x]) {
        out_sel[o] = SelT(-1);
        continue;
      }
      s_sc[row + o] = j == 0 ? p_sc[row + x] + row_tr[0] : -INFINITY;
      s_h1[row + o] = p_h1[row + o];
      s_h2[row + o] = p_h2[row + o];
      out_sel[o] = SelT(j);
    }
    return true;
  }

  // The staged rounds as whole rows; slots past a destination's count are
  // (-inf, 0, 0, -1), and a state that is not live selects -1 and leaves
  // the stale buffer alone. The caller synchronises the block before it.
  template <int LB>
  __device__ __forceinline__ void write(
      const Staged<LB, T, SelT>& st, float* __restrict__ s_sc,
      uint32_t* __restrict__ s_h1, uint32_t* __restrict__ s_h2) const {
    for (int i = threadIdx.x; i < L * T; i += NT) {
      const int j = i / T, x = i % T;
      if (x >= cols) continue;
      const size_t o = j * sC + x;
      const int n = st.n[x];
      if (n < 0) {
        out_sel[o] = SelT(-1);
        continue;
      }
      const bool hit = j < n;
      s_sc[row + o] = hit ? st.sc[j][x] : -INFINITY;
      s_h1[row + o] = hit ? st.h1[j][x] : 0u;
      s_h2[row + o] = hit ? st.h2[j][x] : 0u;
      out_sel[o] = hit ? st.sel[j][x] : SelT(-1);
    }
  }
};

}  // namespace
