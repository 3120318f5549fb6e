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
// What bounds them on this card: merge keeps its 64 candidates x (score, h1,
// h2) in per-thread arrays, exactly as the ACS kernel keeps its 8L
// candidates (csrc/lva_acs.cu), so the arrays live in local memory (768 B of
// stack per thread) and each round streams them twice (max scan, knockout)
// through L1 and L2. That is the point of the probe: its element-op rate is
// the ceiling of the ACS kernel's own pattern. Stream works on one element
// at a time in registers; it is bound by the FP32 / compare throughput and
// is the best case for the same op count. Treepop at the probe's shapes
// (1024 to 4096 columns) is a few thousand threads and measures launch
// latency more than anything else; it checks index order, not speed.
//
// What the design does: one thread per (copy g, column) for merge and
// stream, neighbouring threads on neighbouring columns so every load of the
// [64, columns] inputs is coalesced. The TPU grid re-read one block G times
// in order; here the G copies run in parallel over the one input and each
// copy writes its own output slot [G, columns], so the compiler cannot drop
// any copy's work. The input (3 x 64 x 4096 x 4 B = 3 MiB at the probe's
// shape) stays in L2 for all copies. Registers, shared memory or a K-way
// merge are not used on purpose: they belong to the ACS kernel's redesign.
//
// Exactness: no --use_fast_math and no -ftz, so the denormals among the
// stream's bitcast hashes (bit patterns below 2^23) survive; --fmad=false
// stays, though nothing here multiplies. max is PTX max.NaN.f32, which
// propagates NaN as jnp.maximum and torch.maximum do. Compares are strict
// `>`, so the first maximum wins a tie; an all -inf column selects index 0,
// as jnp.argmax and torch.argmax do.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNc = 64;  // candidates per column, NC of the TPU probes
constexpr int kBlock = 128;
constexpr int kConcatN = 60;  // the concat variant's odd-length start

enum Variant { kArgmax = 0, kReshapePair = 1, kHalves = 2, kConcat = 3 };

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(kBlock) merge_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h1,
    const uint32_t* __restrict__ h2, float* __restrict__ out, int nc,
    int ncol, int rounds, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= total) return;
  const int col = static_cast<int>(t % ncol);
  float csc[kMaxNc];
  uint32_t ch1[kMaxNc];
  uint32_t ch2[kMaxNc];
  for (int i = 0; i < nc; ++i) {
    const size_t k = static_cast<size_t>(i) * ncol + col;
    csc[i] = x[k];
    ch1[i] = h1[k];
    ch2[i] = h2[k];
  }
  float acc = 0.0f;  // sum(outs) starts from 0
  for (int r = 0; r < rounds; ++r) {
    float best = csc[0];
    int bi = 0;
    for (int i = 1; i < nc; ++i) {
      if (csc[i] > best) {
        best = csc[i];
        bi = i;
      }
    }
    const uint32_t k1 = ch1[bi];
    const uint32_t k2 = ch2[bi];
    for (int i = 0; i < nc; ++i) {
      if (ch1[i] == k1 && ch2[i] == k2) csc[i] = -INFINITY;
    }
    // the int32 sum first, then one f32 conversion and one f32 add
    const float o = best + static_cast<float>(static_cast<int32_t>(k1 + k2));
    acc = acc + o;
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kBlock) stream_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ h1,
    const uint32_t* __restrict__ h2, float* __restrict__ out, int nc,
    int ncol, int rounds, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= total) return;
  const int col = static_cast<int>(t % ncol);
  float res = -INFINITY;
  // elementwise, so each element runs all its rounds in registers
  for (int i = 0; i < nc; ++i) {
    const size_t k = static_cast<size_t>(i) * ncol + col;
    float acc = x[k];
    const float b = __uint_as_float(h1[k]);
    const float c = __uint_as_float(h2[k]);
    for (int r = 0; r < rounds; ++r) {
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
      acc = t10 > t11 ? acc : t11;
    }
    res = max_nan(res, acc);
  }
  out[t] = res;
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

int blocks(int64_t threads) {
  return static_cast<int>((threads + kBlock - 1) / kBlock);
}

}  // namespace

// merge and stream: x f32 [nc, ncol], h1 and h2 int32 [nc, ncol] (the
// [NC, F, CT] arrays with F x CT flattened), out f32 [copies, ncol]; every
// copy computes the same columns. Return cudaGetLastError().
extern "C" int probe_merge_launch(const void* x, const void* h1,
                                  const void* h2, void* out, int nc, int ncol,
                                  int rounds, int copies, void* stream) {
  if (nc < 1 || nc > kMaxNc || ncol < 1 || rounds < 0 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(copies) * ncol;
  merge_kernel<<<blocks(total), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<float*>(out), nc, ncol,
      rounds, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_stream_launch(const void* x, const void* h1,
                                   const void* h2, void* out, int nc,
                                   int ncol, int rounds, int copies,
                                   void* stream) {
  if (nc < 1 || nc > kMaxNc || ncol < 1 || rounds < 0 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(copies) * ncol;
  stream_kernel<<<blocks(total), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<float*>(out), nc, ncol,
      rounds, total);
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
