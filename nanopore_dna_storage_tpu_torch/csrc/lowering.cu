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
//   candidates. Two placements of the per-thread state (template variants):
//     regs   every NQ loop fully unrolled, the winner selected by
//            predication, so every index is a compile-time constant and the
//            state can stay in registers;
//     local  runtime-indexed arrays and a runtime loop bound, as K1 holds its
//            candidates today: the state lives in local memory (L1 / L2);
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
// dynrow, int16, copy and alias are a few microseconds of launch latency;
// with more data they would be bound by bytes. fori is bound by operations:
// the function needs a first argmax (3 per candidate) and the winner's
// updates, ~3 NQ + 8 per column and round; regs executes the one-hot sweeps
// besides (~9 NQ + 5), local only what is needed. Its other bound is where
// its 3 NQ words per thread live: in registers at NQ = 64 they take ~200 of
// the 255 a thread may have, which caps residency at 256 threads per SM; in
// local memory at 32 registers 2,048 threads are resident and their stacks
// stream through L1 and L2 every round.
//
// What the design does: one thread per element (per column for fori),
// neighbouring threads on neighbouring columns, so every load and store is
// coalesced. fori runs `copies` copies of the columns, each writing its own
// output slot, so that the card can be filled and no copy's work dropped;
// its threads stride over the (copy, column) items, so that a launch may cap
// the threads per SM (`threads_per_sm`) and separate placement from
// residency.
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

// One (copy, column) item: the fori probe on column col of x f32 and h
// uint32 [NQ, ncol]; nq == NQ (the local placement's loop bound, a runtime
// value as K1's candidate count is); zero == 0.0f.
template <int NQ, int PL>
__device__ __forceinline__ float fori_column(const float* __restrict__ x,
                                             const uint32_t* __restrict__ h,
                                             int nq, int ncol, int col,
                                             int rounds, float zero) {
  float sc[NQ];
  uint32_t hv[NQ];
  int32_t ptr[NQ];
  float acc = 0.0f;
  int32_t psum = 0;
  if constexpr (PL == kRegs) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      sc[i] = x[static_cast<int64_t>(i) * ncol + col];
      hv[i] = h[static_cast<int64_t>(i) * ncol + col];
      ptr[i] = 0;
    }
    for (int r = 0; r < rounds; ++r) {
      float best = sc[0];
      int q = 0;
#pragma unroll
      for (int i = 1; i < NQ; ++i) {
        const bool gt = sc[i] > best;
        best = gt ? sc[i] : best;
        q = gt ? i : q;
      }
      uint32_t hh = 0;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {  // the one-hot sweeps, predicated
        const bool oh = i == q;
        hh += oh ? hv[i] : 0u;
        ptr[i] += oh ? 1 : 0;
        sc[i] = oh ? sc[i] - 1.0f : sc[i];
      }
      acc = (acc + best) + static_cast<float>(hh & 1u) * zero;
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) psum += ptr[i];
  } else {
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
  }
  return acc + static_cast<float>(psum);
}

// out [copies, ncol], total = copies * ncol items; the grid strides over
// them.
template <int NQ, int PL>
__global__ void __launch_bounds__(kBlock) fori_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h,
    float* __restrict__ out, int nq, int ncol, int rounds, float zero,
    int64_t total) {
  for (int64_t t = thread_index(); t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[t] = fori_column<NQ, PL>(x, h, nq, ncol, static_cast<int>(t % ncol),
                                 rounds, zero);
}

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

template <int NQ, int PL>
cudaError_t launch_placed(const float* x, const uint32_t* h, float* out,
                          int ncol, int rounds, float zero, int64_t total,
                          int threads_per_sm, cudaStream_t s) {
  int grid = blocks(total);
  if (threads_per_sm > 0) {  // a grid that holds at most that many per SM
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const int per_sm = threads_per_sm < kBlock ? 1 : threads_per_sm / kBlock;
    if (static_cast<int64_t>(sms) * per_sm < grid) grid = sms * per_sm;
  }
  fori_kernel<NQ, PL><<<grid, kBlock, 0, s>>>(x, h, out, NQ, ncol, rounds,
                                              zero, total);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_fori(int placement, const float* x, const uint32_t* h,
                        float* out, int ncol, int rounds, float zero,
                        int64_t total, int threads_per_sm, cudaStream_t s) {
  return placement == kRegs
             ? launch_placed<NQ, kRegs>(x, h, out, ncol, rounds, zero,
                                        total, threads_per_sm, s)
             : launch_placed<NQ, kLocal>(x, h, out, ncol, rounds, zero,
                                         total, threads_per_sm, s);
}

template <int NQ>
cudaError_t fori_blocks_per_sm(int placement, int* n) {
  return placement == kRegs
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   n, fori_kernel<NQ, kRegs>, kBlock, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   n, fori_kernel<NQ, kLocal>, kBlock, 0);
}

cudaError_t invalid() { return cudaErrorInvalidValue; }

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
// placement 0 regs, 1 local; nq 32 or 64; threads_per_sm 0 for one thread
// per item, else a grid of at most that many threads per SM (in blocks of
// 128, at least one); zero must be 0.0f.
extern "C" int lowering_fori_launch(const void* x, const void* h, void* out,
                                    int placement, int nq, int ncol,
                                    int rounds, int copies,
                                    int threads_per_sm, float zero,
                                    void* stream) {
  if (ncol < 1 || rounds < 0 || copies < 1 || threads_per_sm < 0 ||
      (placement != kRegs && placement != kLocal))
    return static_cast<int>(invalid());
  const auto xs = static_cast<const float*>(x);
  const auto hs = static_cast<const uint32_t*>(h);
  const auto os = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(copies) * ncol;
  if (nq == 32)
    return static_cast<int>(launch_fori<32>(
        placement, xs, hs, os, ncol, rounds, zero, total, threads_per_sm, s));
  if (nq == 64)
    return static_cast<int>(launch_fori<64>(
        placement, xs, hs, os, ncol, rounds, zero, total, threads_per_sm, s));
  return static_cast<int>(invalid());
}

// The fori kernel's resident threads per SM on the current device, as the
// occupancy calculator gives them (its registers and stack), into *threads.
extern "C" int lowering_fori_resident(int placement, int nq, int* threads) {
  if (placement != kRegs && placement != kLocal)
    return static_cast<int>(invalid());
  int n = 0;
  cudaError_t e = nq == 32   ? fori_blocks_per_sm<32>(placement, &n)
                  : nq == 64 ? fori_blocks_per_sm<64>(placement, &n)
                             : invalid();
  *threads = n * kBlock;
  return static_cast<int>(e);
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
