// Lowering probes for Hopper (sm_90a): the primitives the ACS kernel
// (csrc/lva_acs.cu) rests on, one small kernel each.
//
// Replaces the Pallas TPU probes of scripts/tpu_pallas_probe.py, which asked
// whether Mosaic lowers each primitive:
// - dynrow  (`p_dynrow`, pallas_call at :44): out[0] = x[i], the row index
//   i read by the kernel from device memory (the scalar prefetch); K1 reads
//   its window rows at start1[b] + w the same way;
// - int16   (`p_int16`, :62): int16(int32(x) * 64 + 7), wrapping modulo
//   2^16 as numpy's astype and XLA's convert do; K1's int8 / int16
//   selection stores;
// - fori    (`p_fori`, :94): R rounds of first-argmax over NQ candidates per
//   column with a one-hot select, carrying four arrays (scores, hashes,
//   pointers, the running sum); K1's suppression merge, L rounds over 8L
//   candidates. Two placements of the state (template variants):
//     regs   a column's scores in registers over G lanes (1, 2, 4 or 8,
//            adjacent lanes of a warp; lane l holds candidates [l NQ/G,
//            (l+1) NQ/G)), every loop unrolled so that every index is a
//            compile-time constant;
//     local  one thread a column with runtime-indexed arrays and a runtime
//            loop bound, as K1 held its candidates when this probe was
//            written: the state lives in local memory (L1 / L2);
// - copy    (`p_reshape`, :108): [8, L, C] -> [8L, C], which on this card is
//   a plain copy into a new tensor: the cost of the candidate layout;
// - alias   (`p_alias`, :125): stale[s + w] = (stale[s + w] + x[s + w]) + w
//   for w < W, in place (input_output_aliases={2: 0}), s read from device
//   memory; K1's double buffer, whose rows outside the window keep their
//   value.
// `p_repeat` (:27) needs no kernel here: it is expand.cu's lane_map (element
// map, k = 4) at [8, 1024]. The plain PyTorch versions are
// probes/lowering.py `*_ref`; each kernel is held against its plain version
// bit for bit.
//
// What bounds them on this card: at the script's shapes (32 KB to 512 KB)
// dynrow, int16, copy and alias are a few microseconds of launch latency
// (`empty_kernel` below measures the launch alone, at one thread or at
// their grids); with more data they
// would be bound by bytes. fori is bound by operations: the function needs
// a first argmax (3 per candidate) and the winner's updates, ~3 NQ + 8 per
// column and round. local executes only that, from local memory at 32
// registers (2,048 threads resident, their stacks streaming through L1 and
// L2 every round).
//
// regs: each round, every lane runs an adjacent-pair tree over its NQ/G
// scores (the right child only on a strict `>`), then log2 G shuffle steps
// on (score, flat index) at offsets 1, 2, ..., in which the lane whose bit
// is clear keeps its entry unless its partner's score is strictly greater:
// together one pair tree over the NQ candidates, so the first maximum wins.
// The owner of the winner lowers its score by one and takes its hash, a
// predicated subtract and move at each of its slots, and counts one
// pointer; the pointers enter the result only through their sum, so each
// lane keeps the count of its own. One shuffle from the owner brings the
// hash to every lane. At one lane a column the hashes stay in memory and
// the winner's is read back at its flat index: 64 more registers spilled
// at NQ = 64, and that kernel runs where many warps hide the read. (At
// G > 1, where few warps run, that read put an L2 round trip into every
// round, ptxas placing its use right after the load: 0.18 us a round at
// the script's shape.) The launcher takes the fewest lanes that give
// every SM a block, at most 8. On an H100 80GB HBM3 at 700 W: from CUDA
// graphs at [32, 1024] x 18 rounds 3.4-3.6 us a call, at [64, 1024] x 8
// 2.7-2.9 us (G = 8, 32 and 47 registers); over 256 copies 0.044 and
// 0.039 ms (G = 1, 56 and 96 registers). The first form of regs (one
// thread a column, hashes and pointers in registers too, the winner
// applied by one-hot sweeps over all NQ candidates, ~9 NQ + 5 ops a
// round; 247 registers at NQ = 64) took 5.9-6.2 us and 0.059-0.062 ms
// (PERF.md).
//
// What the design does: one thread per element (G per column for fori
// regs), neighbouring threads on neighbouring columns, so loads and stores
// are coalesced. fori runs `copies` copies of the columns, each writing its
// own output slot, so that the card can be filled and no copy's work
// dropped; its threads stride over the (copy, column) items, a warp's
// groups together, so that a launch may cap the threads per SM
// (`threads_per_sm`) and separate placement from residency.
// Out-of-range indices never reach memory: dynrow clamps its row into
// [0, P) as jax.lax.dynamic_slice clamps its start; alias skips the window
// rows outside [0, P).
//
// Exactness: --fmad=false, and the one-hot term f32(hh & 1) * 0 multiplies
// by a zero the wrapper passes as an argument, so that the compiler can
// neither contract nor drop it, nor the hash sum behind it. Compares are
// strict `>`, so the first maximum wins a tie, as jnp.argmax does; scores
// are finite or infinite, never NaN.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

enum Placement { kRegs = 0, kLocal = 1 };

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(kBlock) dynrow_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ idx,
    float* __restrict__ y, int P, int C) {
  const int64_t j = thread_index();
  if (j >= C) return;
  int i = idx[0];
  i = i < 0 ? 0 : (i >= P ? P - 1 : i);
  y[j] = x[static_cast<int64_t>(i) * C + j];
}

__global__ void __launch_bounds__(kBlock) int16_kernel(
    const int32_t* __restrict__ x, int16_t* __restrict__ y, int64_t n) {
  const int64_t t = thread_index();
  if (t >= n) return;
  // in uint32, where the wrap is defined; then modulo 2^16
  const uint32_t v = static_cast<uint32_t>(x[t]) * 64u + 7u;
  y[t] = static_cast<int16_t>(static_cast<uint16_t>(v));
}

// The lowest-index maximum of cs[LO, LO + N) as (score, index): the two
// halves reduced depth first, then the right half taken only if strictly
// greater, so the left, lower indices win a tie. Every index is a
// compile-time constant. (csrc/lva_lse.cu's helper, kept apart so that each
// library builds alone.)
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

// The fori probe in the regs placement on column col of x f32 and h uint32
// [NQ, ncol], lane `lane` of the G that share it; every lane returns the
// result. zero == 0.0f.
template <int NQ, int G>
__device__ __forceinline__ float fori_lanes(const float* __restrict__ x,
                                            const uint32_t* __restrict__ h,
                                            int ncol, int col, int lane,
                                            int rounds, float zero) {
  constexpr int N = NQ / G;  // candidates a lane holds
  // the hashes in registers, or read back from h (one lane a column)
  constexpr bool kHashRegs = G > 1;
  const int base = lane * N;  // flat index of the lane's first
  float sc[N];
  uint32_t hv[kHashRegs ? N : 1];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t at = static_cast<int64_t>(base + j) * ncol + col;
    sc[j] = __ldg(x + at);
    if constexpr (kHashRegs) hv[j] = __ldg(h + at);
  }
  float acc = 0.0f;
  int32_t count = 0;  // the pointers of the lane's candidates, summed
  for (int r = 0; r < rounds; ++r) {
    float best;
    int k;
    tree_max<0, N>(sc, best, k);
    int f = base + k;
#pragma unroll
    for (int s = 1; s < G; s <<= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best, s, G);
      const int f2 = __shfl_xor_sync(0xffffffffu, f, s, G);
      // the partner's entry is the pair's second if this lane's bit s is
      // clear; the second wins only if strictly greater (no NaN here)
      const bool take = v2 > best || ((lane & s) != 0 && v2 == best);
      best = take ? v2 : best;
      f = take ? f2 : f;
    }
    const int d = f - base;  // in [0, N) in the winner's lane only
    uint32_t hh = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (d == j) {
        sc[j] = sc[j] - 1.0f;
        if constexpr (kHashRegs) hh = hv[j];
      }
    }
    count += static_cast<unsigned>(d) < static_cast<unsigned>(N) ? 1 : 0;
    if constexpr (kHashRegs)
      hh = __shfl_sync(0xffffffffu, hh, f / N, G);
    else
      hh = __ldg(h + static_cast<int64_t>(f) * ncol + col);
    acc = (acc + best) + static_cast<float>(hh & 1u) * zero;
  }
#pragma unroll
  for (int s = 1; s < G; s <<= 1)
    count += __shfl_xor_sync(0xffffffffu, count, s, G);
  return acc + static_cast<float>(count);
}

// fori regs: groups of G adjacent lanes stride over the (copy, column) items
// of out [copies, ncol], total = copies * ncol, a warp's groups together; a
// group past the last item runs on the last one and writes nothing, so that
// every lane of a warp reaches the shuffles.
template <int NQ, int G>
__global__ void __launch_bounds__(kBlock) fori_regs_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h,
    float* __restrict__ out, int ncol, int rounds, float zero,
    int64_t total) {
  constexpr int kWarpItems = 32 / G;
  const int lane = threadIdx.x % G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kBlock / G);
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * (kBlock / G) +
                   threadIdx.x / 32 * kWarpItems;
       w < total; w += stride) {
    const int64_t t = w + threadIdx.x % 32 / G;
    const bool live = t < total;
    const float y = fori_lanes<NQ, G>(
        x, h, ncol, static_cast<int>((live ? t : total - 1) % ncol), lane,
        rounds, zero);
    if (live && lane == 0) out[t] = y;
  }
}

// One (copy, column) item of the local placement: the fori probe on column
// col of x f32 and h uint32 [NQ, ncol] with its state in runtime-indexed
// arrays; nq == NQ (a runtime loop bound, as K1's candidate count is);
// zero == 0.0f.
template <int NQ>
__device__ __forceinline__ float fori_local(const float* __restrict__ x,
                                            const uint32_t* __restrict__ h,
                                            int nq, int ncol, int col,
                                            int rounds, float zero) {
  float sc[NQ];
  uint32_t hv[NQ];
  int32_t ptr[NQ];
  float acc = 0.0f;
  int32_t psum = 0;
  for (int i = 0; i < nq; ++i) {
    sc[i] = x[static_cast<int64_t>(i) * ncol + col];
    hv[i] = h[static_cast<int64_t>(i) * ncol + col];
    ptr[i] = 0;
  }
  for (int r = 0; r < rounds; ++r) {
    float best = sc[0];
    int q = 0;
    for (int i = 1; i < nq; ++i) {
      if (sc[i] > best) {
        best = sc[i];
        q = i;
      }
    }
    // the one-hot sweeps touch only the winner: the same values
    const uint32_t hh = hv[q];
    ptr[q] += 1;
    sc[q] = sc[q] - 1.0f;
    acc = (acc + best) + static_cast<float>(hh & 1u) * zero;
  }
  for (int i = 0; i < nq; ++i) psum += ptr[i];
  return acc + static_cast<float>(psum);
}

// fori local: out [copies, ncol], total = copies * ncol items; the grid
// strides over them.
template <int NQ>
__global__ void __launch_bounds__(kBlock) fori_local_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h,
    float* __restrict__ out, int nq, int ncol, int rounds, float zero,
    int64_t total) {
  for (int64_t t = thread_index(); t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[t] = fori_local<NQ>(x, h, nq, ncol, static_cast<int>(t % ncol),
                            rounds, zero);
}

// Nothing: a launch and its completion, the floor under every kernel here.
__global__ void empty_kernel() {}

__global__ void __launch_bounds__(kBlock) copy_kernel(
    const float4* __restrict__ x, float4* __restrict__ y, int64_t n4) {
  const int64_t t = thread_index();
  if (t < n4) y[t] = x[t];
}

// stale, x f32 [P, row]; s int32 [1]; one thread per (w, element) of the
// window.
__global__ void __launch_bounds__(kBlock) alias_kernel(
    float* __restrict__ stale, const float* __restrict__ x,
    const int32_t* __restrict__ s, int P, int W, int row) {
  const int64_t t = thread_index();
  if (t >= static_cast<int64_t>(W) * row) return;
  const int w = static_cast<int>(t / row);
  const int64_t p = static_cast<int64_t>(s[0]) + w;
  if (p < 0 || p >= P) return;
  const int64_t k = p * row + t % row;
  stale[k] = (stale[k] + x[k]) + static_cast<float>(w);
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kBlock - 1) / kBlock);
}

cudaError_t invalid() { return cudaErrorInvalidValue; }

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

using ForiFn = void (*)(const float*, const uint32_t*, float*, int, int,
                        float, int64_t);
using LocalFn = void (*)(const float*, const uint32_t*, float*, int, int,
                         int, float, int64_t);

template <int NQ>
ForiFn regs_lanes(int lanes) {
  switch (lanes) {
    case 1: return fori_regs_kernel<NQ, 1>;
    case 2: return fori_regs_kernel<NQ, 2>;
    case 4: return fori_regs_kernel<NQ, 4>;
    case 8: return fori_regs_kernel<NQ, 8>;
    default: return nullptr;
  }
}

// The kernels built: regs at nq 32 and 64 and lanes 1, 2, 4, 8; local at
// nq 32 and 64. nullptr for any other.
ForiFn regs_fn(int nq, int lanes) {
  return nq == 32 ? regs_lanes<32>(lanes)
         : nq == 64 ? regs_lanes<64>(lanes) : nullptr;
}

LocalFn local_fn(int nq) {
  return nq == 32 ? fori_local_kernel<32>
         : nq == 64 ? fori_local_kernel<64> : nullptr;
}

const void* fori_fn(int placement, int nq, int lanes) {
  if (placement == kLocal)
    return lanes == 1 ? reinterpret_cast<const void*>(local_fn(nq)) : nullptr;
  return placement == kRegs ? reinterpret_cast<const void*>(regs_fn(nq, lanes))
                            : nullptr;
}

// The fewest lanes (1, 2, 4, 8) that give every SM of the current device a
// block of fori regs over `items` items; 0 if the query fails.
int fori_auto_lanes(int64_t items) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return 0;
  int g = 1;
  while (g < 8 && items * g < static_cast<int64_t>(sms) * kBlock) g *= 2;
  return g;
}

}  // namespace

// dynrow: x f32 [P, C], idx int32 [1] (device), y f32 [1, C].
extern "C" int lowering_dynrow_launch(const void* x, const void* idx, void* y,
                                      int P, int C, void* stream) {
  if (P < 1 || C < 1) return static_cast<int>(invalid());
  dynrow_kernel<<<blocks(C), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(y), P, C);
  return static_cast<int>(cudaGetLastError());
}

// int16: x int32 [n], y int16 [n].
extern "C" int lowering_int16_launch(const void* x, void* y, int64_t n,
                                     void* stream) {
  if (n < 1) return static_cast<int>(invalid());
  int16_kernel<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int16_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// fori: x f32 [nq, ncol], h uint32 [nq, ncol], out f32 [copies, ncol];
// placement 0 regs, 1 local; nq 32 or 64; lanes (regs only) 1, 2, 4 or 8 a
// column, or 0 for `lowering_fori_lanes(copies * ncol)`; threads_per_sm 0
// for one thread per item (G per item in regs), else a grid of at most that
// many threads per SM (in blocks of 128, at least one); zero must be 0.0f.
extern "C" int lowering_fori_launch(const void* x, const void* h, void* out,
                                    int placement, int nq, int ncol,
                                    int rounds, int copies, int lanes,
                                    int threads_per_sm, float zero,
                                    void* stream) {
  if (ncol < 1 || rounds < 0 || copies < 1 || threads_per_sm < 0 ||
      lanes < 0 || (placement == kLocal && lanes > 1))
    return static_cast<int>(invalid());
  const int64_t total = static_cast<int64_t>(copies) * ncol;
  if (placement == kLocal) lanes = 1;
  if (lanes == 0 && (lanes = fori_auto_lanes(total)) == 0)
    return static_cast<int>(cudaGetLastError());
  if (fori_fn(placement, nq, lanes) == nullptr)
    return static_cast<int>(invalid());
  int grid = blocks(total * lanes);
  if (threads_per_sm > 0) {  // a grid that holds at most that many per SM
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int per_sm = threads_per_sm < kBlock ? 1 : threads_per_sm / kBlock;
    if (static_cast<int64_t>(sms) * per_sm < grid) grid = sms * per_sm;
  }
  const auto xs = static_cast<const float*>(x);
  const auto hs = static_cast<const uint32_t*>(h);
  const auto os = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (placement == kLocal)
    local_fn(nq)<<<grid, kBlock, 0, s>>>(xs, hs, os, nq, ncol, rounds, zero,
                                         total);
  else
    regs_fn(nq, lanes)<<<grid, kBlock, 0, s>>>(xs, hs, os, ncol, rounds,
                                               zero, total);
  return static_cast<int>(cudaGetLastError());
}

// The lanes a column `lowering_fori_launch` takes in regs for `items`
// items when given 0, on the current device; 0 if the query fails.
extern "C" int lowering_fori_lanes(int64_t items) {
  return fori_auto_lanes(items);
}

// The registers, local bytes (stack frame and spills) and resident threads
// per SM (the occupancy calculator, blocks of 128) of the fori kernel of
// (placement, nq, lanes) on the current device, into out[0..2]; lanes is 1
// for local.
extern "C" int lowering_fori_info(int placement, int nq, int lanes,
                                  int* out) {
  const void* fn = fori_fn(placement, nq, lanes);
  if (fn == nullptr) return static_cast<int>(invalid());
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  int nb = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, kBlock, 0);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = nb * kBlock;
  return static_cast<int>(e);
}

// The empty kernel at `blocks` blocks of `threads`: the launch floor, at
// one thread or at another kernel's grid.
extern "C" int lowering_empty_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024)
    return static_cast<int>(invalid());
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// copy (the reshape): x, y f32 [n], n a multiple of 4 and both 16-byte
// aligned, copied as 16-byte vectors.
extern "C" int lowering_copy_launch(const void* x, void* y, int64_t n,
                                    void* stream) {
  if (n < 4 || n % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(invalid());
  copy_kernel<<<blocks(n / 4), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n / 4);
  return static_cast<int>(cudaGetLastError());
}

// alias: stale f32 [P, row] updated in place, x f32 [P, row], s int32 [1]
// (device), W window rows.
extern "C" int lowering_alias_launch(void* stale, const void* x,
                                     const void* s, int P, int W, int row,
                                     void* stream) {
  if (P < 1 || W < 1 || row < 1) return static_cast<int>(invalid());
  alias_kernel<<<blocks(static_cast<int64_t>(W) * row), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(stale), static_cast<const float*>(x),
      static_cast<const int32_t*>(s), P, W, row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lowering_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
