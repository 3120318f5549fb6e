// Selection traceback of the list-Viterbi decode for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package walks the selections in XLA
// (nanopore_dna_storage_tpu/ops/lva_pallas.py `_tb_chunk`, a lax.scan over
// the blocks, lva_pallas.py:1086-1168). The port's plain version is
// ops/lva_decode.py `traceback_ref`, a loop over the T block steps of about
// 86 small PyTorch launches each, which this kernel is held against bit for
// bit; its docstring states the semantics.
//
// One launch a decode, one thread a chain: the B x 8L final-state chains of
// a batch, a read's chains in neighbouring threads. A chain acts only at
// the block t == tw, where tw is the last block whose window wrote the
// chain's row, and tw falls at every step it acts (the next tw is at most
// t - 1). So the thread jumps from each tw straight to the next and visits
// only the blocks where the chain acts; the loop's blocks where it idles
// are never visited, and no step needs the host. A step reads one
// selection code, applies the loop body's arithmetic, and finds the next tw
// from the window bounds (`lastwrite`); a chain ends when it hits the
// initial buffers, where `okend` is decided.
//
// What bounds it on this card. Not the bytes: at experiment 7 (B=24, L=8,
// m=11) the walk reads about 1,536 chains x 418 steps x ~24 B, some 15 MB,
// ~5 us at 3.35 TB/s. The steps of a chain depend on each other: a step's
// selection address needs the previous step's code. So the floor is the
// longest chain's steps times one device-memory round trip, <= 418 x ~1 us
// (`lva_traceback_round_trip` measures the round trip on the card).
// The design keeps one load on that chain a step: the read's beam starts
// are staged in shared memory once a block (where they fit in what 48 KB
// leaves beside the static shared memory, else read through the read-only
// cache), the merge-row map in shared memory;
// the window bounds of both possible next rows (a stay keeps the row, a
// move takes the one below), the puncture pattern, the message bits and
// the candidate table are loaded before the code arrives, since none of
// them depends on it. The message words stay in registers, a compile-time
// bucket of Mw words with unrolled predicated ORs (no register indexed at
// run time), and are written once at the end as the int64 values the
// plain version returns. The selection type is a template parameter:
// int8 codes q*16 + slot for L <= 16, int16 codes q*64 + slot above
// (ops/lva_consts.py `sel_format`), so one kernel serves max and logsumexp
// combining at any list size. Offsets into the selections are 64-bit: at
// experiment 7 they span ~64 GB.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNcrf = 8;      // CRF states
constexpr int kNq = 8;        // merge rows per CRF destination (NQ_MAX)
constexpr int kThreads = 64;  // chains a block

// The largest block t' <= tmax of parity par whose window wrote a row with
// window bounds [lo, hi]; -1 if there is none (ops/lva_decode.py
// `lastwrite` for one chain).
__device__ __forceinline__ int lastwrite(int64_t lo, int64_t hi,
                                         int64_t tmax, int par) {
  int64_t x = tmax < hi ? tmax : hi;
  x -= (x - par) & 1;
  return x >= lo ? static_cast<int>(x) : -1;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// sels [T, B, W, 8L, C] of type Sel; starts [B, T], nblks [B], tlo and thi
// [B, P] int64; qmap [8, 8], pattern [P], nbits [2, C], cstar [4, 4, C]
// int32. Writes words [B, 8L, Mw] int64 and okend [B, 8L].
template <typename Sel, int kMw>
__global__ void __launch_bounds__(kThreads) lva_traceback_kernel(
    const void* __restrict__ sels_v, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ nblks, const int64_t* __restrict__ tlo,
    const int64_t* __restrict__ thi, const int32_t* __restrict__ qmap,
    const int32_t* __restrict__ pattern, const int32_t* __restrict__ nbits,
    const int32_t* __restrict__ cstar, int64_t* __restrict__ words,
    uint8_t* __restrict__ okend, int B, int T, int W, int L, int C, int P,
    int Mw, int last_row, int init_state, int final_state, int staged) {
  // a code is q * shift + slot: shift 16 for int8, 64 for int16
  constexpr int kLog2Shift = sizeof(Sel) == 1 ? 4 : 6;
  const Sel* __restrict__ sels = static_cast<const Sel*>(sels_v);
  extern __shared__ int32_t sh_starts[];
  __shared__ int32_t sh_qmap[kNcrf * kNq];

  const int nch = kNcrf * L;
  const int64_t total = static_cast<int64_t>(B) * nch;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t g = first + threadIdx.x;
  const int b0 = static_cast<int>(first / nch);
  const int64_t last = (first + kThreads < total ? first + kThreads : total);
  const int b1 = static_cast<int>((last - 1) / nch);
  for (int i = threadIdx.x; i < kNcrf * kNq; i += kThreads)
    sh_qmap[i] = __ldg(qmap + i);
  if (staged) {
    const int n = (b1 - b0 + 1) * T;
    const int64_t* src = starts + static_cast<int64_t>(b0) * T;
    for (int i = threadIdx.x; i < n; i += kThreads)
      sh_starts[i] = static_cast<int32_t>(__ldg(src + i));
  }
  __syncthreads();
  if (g >= total) return;

  const int b = static_cast<int>(g / nch);
  const int ch = static_cast<int>(g - static_cast<int64_t>(b) * nch);
  const int64_t* lo_b = tlo + static_cast<int64_t>(b) * P;
  const int64_t* hi_b = thi + static_cast<int64_t>(b) * P;
  const int32_t* st_sh = sh_starts + (b - b0) * T;
  const int64_t* st_g = starts + static_cast<int64_t>(b) * T;
  // one block's selections: [B, W, 8L, C]
  const int64_t block_stride = static_cast<int64_t>(B) * W * nch * C;
  const int64_t read_off = static_cast<int64_t>(b) * W;

  int pos = last_row, conv = final_state, f = ch / L, slot = ch - f * L;
  const int64_t n1 = __ldg(nblks + b) - 1;
  int tw = lastwrite(__ldg(lo_b + pos), __ldg(hi_b + pos), n1,
                     static_cast<int>(n1 & 1));
  if (tw >= T) tw = -1;  // the plain loop never reaches such a block

  uint32_t w[kMw];
#pragma unroll
  for (int k = 0; k < kMw; ++k) w[k] = 0u;
  int bitcnt = 0;
  bool ok = false;
  while (tw >= 0) {
    const int t = tw;
    const int start = staged ? st_sh[t] : static_cast<int>(__ldg(st_g + t));
    const int wi = clampi(pos - start - 1, 0, W - 1);
    const int64_t at = t * block_stride
        + ((read_off + wi) * nch + f * L + slot) * C + conv;
    const int code = static_cast<int>(__ldg(sels + at));

    // none of these depends on the code: they load while it is in flight
    const int pm = pos > 0 ? pos - 1 : 0;
    const int64_t lo_stay = __ldg(lo_b + pos), hi_stay = __ldg(hi_b + pos);
    const int64_t lo_move = __ldg(lo_b + pm), hi_move = __ldg(hi_b + pm);
    const int pat = __ldg(pattern + pos);
    const int kvar = pat != 0;
    const uint32_t nb = static_cast<uint32_t>(__ldg(nbits + kvar * C + conv));
    const int c = clampi(
        __ldg(cstar + (clampi(pat, 0, 3) * 4 + (f & 3)) * C + conv), 0, 3);
    const int csrc = ((2 << kvar) * conv + c) % C;  // natural predecessor

    // the code split as the plain version's floor division and remainder
    // (an empty selection, -1, reads as a stay from slot shift - 1)
    const int q = clampi(code >> kLog2Shift, 0, kNq - 1);
    const int lsrc = clampi(code & ((1 << kLog2Shift) - 1), 0, L - 1);
    const bool stay = q == 0;
    if (!stay) {
      const int off = bitcnt & 31, widx = bitcnt >> 5;
      const uint32_t lo = nb << off;
      const uint32_t hi = off == 0 ? 0u : (nb >> 1) >> (31 - off);
#pragma unroll
      for (int k = 0; k < kMw; ++k)
        w[k] |= (k == widx ? lo : 0u) | (k == widx + 1 ? hi : 0u);
      bitcnt += 1 + kvar;
    }
    const int npos = stay ? pos : pos - 1;
    const int nconv = stay ? conv : csrc;
    const int nf = stay ? f : sh_qmap[f * kNq + q];
    const int par = (t - 1) & 1;
    const int ntw = stay ? lastwrite(lo_stay, hi_stay, t - 1, par)
                         : lastwrite(lo_move, hi_move, t - 1, par);
    if (ntw < 0)  // hit the initial buffers: only row 1, state, slot 0 live
      ok = par == 1 && npos == 1 && nconv == init_state && lsrc == 0;
    pos = npos;
    conv = nconv;
    f = nf;
    slot = lsrc;
    tw = ntw;
  }
  int64_t* out = words + g * Mw;
#pragma unroll
  for (int k = 0; k < kMw; ++k)
    if (k < Mw) out[k] = static_cast<int64_t>(w[k]);
  okend[g] = ok ? 1 : 0;
}

using KernelFn = void (*)(const void*, const int64_t*, const int64_t*,
                          const int64_t*, const int64_t*, const int32_t*,
                          const int32_t*, const int32_t*, const int32_t*,
                          int64_t*, uint8_t*, int, int, int, int, int, int,
                          int, int, int, int, int);

template <typename Sel>
KernelFn words_bucket(int Mw) {
  if (Mw <= 4) return lva_traceback_kernel<Sel, 4>;
  if (Mw <= 8) return lva_traceback_kernel<Sel, 8>;
  if (Mw <= 16) return lva_traceback_kernel<Sel, 16>;
  return lva_traceback_kernel<Sel, 32>;
}

// int8 selections at L <= 16, int16 above (sel_format)
KernelFn bucket(int L, int Mw) {
  return L <= 16 ? words_bucket<int8_t>(Mw) : words_bucket<int16_t>(Mw);
}

bool bad_args(int L, int Mw) { return L < 1 || Mw < 1 || Mw > 32; }

// Into *limit, the most dynamic shared memory a launch of k may take
// without an opt-in: 48 KB less the kernel's static shared memory (the
// merge-row map), or the function's own maximum where that is less.
cudaError_t stage_limit(KernelFn k, int* limit) {
  cudaFuncAttributes at{};
  const cudaError_t e = cudaFuncGetAttributes(&at, k);
  const int left = 48 * 1024 - static_cast<int>(at.sharedSizeBytes);
  *limit = at.maxDynamicSharedSizeBytes < left ? at.maxDynamicSharedSizeBytes
                                               : left;
  return e;
}

}  // namespace

extern "C" int lva_traceback_launch(
    const void* sels, const void* starts, const void* nblks, const void* tlo,
    const void* thi, const void* qmap, const void* pattern, const void* nbits,
    const void* cstar, void* words, void* okend, int B, int T, int W, int L,
    int C, int P, int Mw, int last_row, int init_state, int final_state,
    void* stream) {
  if (bad_args(L, Mw) || B < 1 || T < 1 || W < 1 || C < 1 || P < 1 ||
      last_row < 0 || last_row >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nch = static_cast<int64_t>(kNcrf) * L;
  const int64_t blocks = (B * nch + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // a block's chains span at most this many reads
  const int64_t reads = (kThreads - 1) / nch + 2;
  const int64_t stage = reads * T * static_cast<int64_t>(sizeof(int32_t));
  const KernelFn k = bucket(L, Mw);
  int limit = 0;
  const cudaError_t e = stage_limit(k, &limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int staged = stage <= limit;
  k<<<static_cast<unsigned>(blocks), kThreads,
                  staged ? static_cast<size_t>(stage) : 0,
                  static_cast<cudaStream_t>(stream)>>>(
      sels, static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(nblks), static_cast<const int64_t*>(tlo),
      static_cast<const int64_t*>(thi), static_cast<const int32_t*>(qmap),
      static_cast<const int32_t*>(pattern), static_cast<const int32_t*>(nbits),
      static_cast<const int32_t*>(cstar), static_cast<int64_t*>(words),
      static_cast<uint8_t*>(okend), B, T, W, L, C, P, Mw, last_row,
      init_state, final_state, staged);
  return static_cast<int>(cudaGetLastError());
}

// The registers, local memory (stack and spills, bytes) and resident threads
// per SM (the occupancy calculator, at the kernel's block of 64 with no
// dynamic shared memory) of the build that runs list size L with Mw message
// words, and the most shared memory (bytes) a launch of it stages the beam
// starts in, into out[0..3].
extern "C" int lva_traceback_info(int L, int Mw, int* out) {
  if (bad_args(L, Mw)) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = bucket(L, Mw);
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, k);
  int blocks = 0, limit = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
  if (e == cudaSuccess) e = stage_limit(k, &limit);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = blocks * kThreads;
  out[3] = limit;
  return static_cast<int>(e);
}

// One thread follows next[] for `steps` hops from index 0, each hop a load
// through the read-only cache, as the traceback's, whose address is the
// value of the one before; writes where it ends to *end. Over a buffer well
// above the L2's 50 MB, in an order that visits every line, the time a hop
// is the device-memory round trip that sets the traceback's latency floor.
namespace {

__global__ void round_trip_kernel(const int64_t* __restrict__ next,
                                  int64_t steps, int64_t* __restrict__ end) {
  int64_t i = 0;
  for (int64_t s = 0; s < steps; ++s) i = __ldg(next + i);
  *end = i;
}

}  // namespace

extern "C" int lva_traceback_round_trip(const void* next, int64_t steps,
                                        void* end, void* stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  round_trip_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(next), steps, static_cast<int64_t*>(end));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lva_traceback_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
