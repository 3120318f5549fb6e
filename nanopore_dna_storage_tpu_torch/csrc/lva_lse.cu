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
// predecessor, as lva_acs.cu addresses them) into arrays, and runs L rounds
// of two passes over them: a max scan with strict `>` in ascending flat index
// `q*L + slot` (the lowest index wins ties, and a round whose candidates are
// all -inf pops nothing), then a class pass in the same order that adds one
// term per live member and knocks every member out.
//
// What bounds it on this card: operations. At m=11 L=8 a flip destination
// has 64 candidates, so a round is 64 compares and selects for the scan and
// 64 pair tests and knockouts for the class pass, L rounds per thread, while
// the bytes are one read of every slot of the previous rows and one write of
// the outputs, and the exp and log calls are few (chip_smoke.py counts all
// three on the step's data: merge_roofline.acs_lse_needed). On an H100 80GB
// HBM3 at 700 W the kernel takes 3.92 ms at B=4 against a 0.206 ms bound by
// operations, about 5% of it (PERF.md). The arrays are indexed at run time,
// so they live in local memory (768 bytes a thread at L <= 8, 40 registers,
// 1,536 threads per SM), as the first flat scan of K1 kept them; how the time
// splits between those local loads and the double-precision exp is not
// measured. This kernel is the simple, exact one; it is not yet tuned.
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

  // the candidates, flat index q*L + slot; a -inf candidate's hashes are
  // never read, since it can neither win a round nor join a sum
  const int n = row_count * L;
  float cs[kNq * LB];
  uint32_t c1[kNq * LB], c2[kNq * LB];
  for (int q = 0; q < row_count; ++q) {
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
    // every thread of a warp is on the same slot: the stores coalesce
    s_sc[row + r * sC] = val;
    s_h1[row + r * sC] = a;
    s_h2[row + r * sC] = bb;
    out_sel[r * sC] = SelT(code);
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
