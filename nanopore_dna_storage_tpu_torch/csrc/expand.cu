// Lane-map and transpose probes for Hopper (sm_90a): the predecessor
// expansion y[j] = x[j >> log k] and its relatives, done three ways.
//
// Replaces the Pallas TPU probes of scripts/:
// - tpu_pallas_probe2.py `_run` (pallas_call at :19, used by p_take,
//   p_jnprepeat, p_pltpurepeat_semantics, p_roll, p_butterfly),
//   `p_subl_upsample` (:85) and `p_transpose` (:73);
// - tpu_repeat_probe.py `run` (pallas_call at :52): jnp.repeat,
//   pltpu.repeat and the roll butterfly at k in {2, 4};
// - tpu_expand_probe.py `run` (pallas_call at :70): broadcast / stack
//   reshapes and the masked roll butterfly at k in {2, 4}.
// The plain PyTorch versions are probes/expand.py `lane_map_ref` and
// `transpose_ref`; each kernel is held against them bit for bit.
//
// lane_map: y[g, r, j] = x[sr, sc] with (sr, sc) = src(r, j) of one map:
//   element  sc = j >> log k      (jnp.repeat, take, the reshapes)
//   tile     sc = j mod n         (pltpu.repeat: it tiles, n = cols / k)
//   pair     sc = j & ~1          (p_roll: where(j even, x, roll(x, 1)))
//   row      sr = r >> 1          (p_subl_upsample: rows repeated twice)
// in three forms (template variants):
//   gather     every thread loads its own source;
//   shfl       the element map only, k a power of two up to 32: each warp
//              loads its 32 / k sources once and spreads them with
//              __shfl_sync;
//   butterfly  the TPU formulation, carried over only so the card can time
//              it: a row is staged in shared memory and the stages
//              y = where(mask[s], roll(y, d_s), y) run with the scripts'
//              own shifts and masks (data-independent, computed by the
//              wrapper), from the identity or from the tile of the prefix.
// transpose: [R, C] -> [C, R] through a 32 x 33 shared-memory tile.
//
// What bounds them on this card: bytes. No form does arithmetic; a gather
// reads 4 B and writes 4 B per element, so at the scripts' shapes (32 to
// 64 KB) a launch is a few microseconds of latency, and with many copies
// the output writes to device memory bound it. The butterfly reads its
// [S, cols] int32 masks once per row and does S shared-memory passes with
// a barrier each: it is bound by shared-memory traffic and barriers, which
// is what the card can say about the TPU's roll formulation.
//
// What the design does: one thread per output element, neighbouring
// threads on neighbouring columns, so stores coalesce and the source loads
// of a warp fall in one or a few 128-byte lines (the input stays in L1 and
// L2 for all copies). Each of the `copies` copies writes its own output
// slot, as the TPU probes' grid steps each wrote theirs, so no copy's work
// can be dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxStages = 32;

enum Form { kGather = 0, kShfl = 1, kButterfly = 2 };
enum Map { kElement = 0, kTile = 1, kPair = 2, kRow = 3 };

struct Stages {
  int shift[kMaxStages];
};

__device__ __forceinline__ void source(int map, int p, int r, int j, int& sr,
                                       int& sc) {
  sr = r;
  sc = j;
  switch (map) {
    case kElement:
      sc = j >> p;  // p = log2 k
      break;
    case kTile:
      sc = j % p;  // p = n, the prefix length
      break;
    case kPair:
      sc = j & ~1;
      break;
    default:  // kRow
      sr = r >> 1;
      break;
  }
}

// gather and shfl: one thread per output element t of [copies, rout, cout];
// butterfly: one block per (copy, row), with 2 x cout floats of dynamic
// shared memory.
template <int F>
__global__ void __launch_bounds__(kBlock) lane_map_kernel(
    const float* __restrict__ x, float* __restrict__ y, int map, int p,
    int cin, int rout, int cout, int64_t total,
    const int32_t* __restrict__ masks, Stages st, int nst, int tile_start) {
  if constexpr (F == kButterfly) {
    extern __shared__ float buf[];
    const int row = blockIdx.x % rout;
    float* cur = buf;
    float* nxt = buf + cout;
    const int n = cout >> p;
    const float* xr = x + static_cast<size_t>(row) * cin;
    for (int j = threadIdx.x; j < cout; j += blockDim.x)
      cur[j] = xr[tile_start ? j % n : j];
    __syncthreads();
    for (int s = 0; s < nst; ++s) {
      const int d = st.shift[s];
      const int32_t* m = masks + static_cast<size_t>(s) * cout;
      for (int j = threadIdx.x; j < cout; j += blockDim.x) {
        // roll(y, d)[j] = y[(j - d) mod cout], as jnp.roll and pltpu.roll
        const int src = j >= d ? j - d : j - d + cout;
        nxt[j] = m[j] != 0 ? cur[src] : cur[j];
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    float* out = y + static_cast<size_t>(blockIdx.x) * cout;
    for (int j = threadIdx.x; j < cout; j += blockDim.x) out[j] = cur[j];
  } else {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    // total is a multiple of 32 for shfl, so whole warps leave together
    if (t >= total) return;
    const int per = rout * cout;
    const int e = static_cast<int>(t % per);
    const int r = e / cout;
    const int j = e % cout;
    if constexpr (F == kShfl) {
      const int lane = threadIdx.x & 31;
      const int j0 = j - lane;  // the warp's first column, same row
      float v = 0.0f;
      if (lane < (32 >> p))
        v = x[static_cast<size_t>(r) * cin + (j0 >> p) + lane];
      y[t] = __shfl_sync(0xffffffffu, v, lane >> p);
    } else {
      int sr, sc;
      source(map, p, r, j, sr, sc);
      y[t] = x[static_cast<size_t>(sr) * cin + sc];
    }
  }
}

__global__ void __launch_bounds__(kBlock) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ y, int R, int C,
    int tiles_r, int tiles_c) {
  __shared__ float tile[32][33];  // the pad keeps column reads conflict-free
  const int per = tiles_r * tiles_c;
  const int copy = blockIdx.x / per;
  const int rem = blockIdx.x % per;
  const int r0 = (rem / tiles_c) * 32;
  const int c0 = (rem % tiles_c) * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;  // 8 rows of 32 threads
  for (int i = ty; i < 32; i += kBlock / 32) {
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < C) tile[i][tx] = x[static_cast<size_t>(r) * C + c];
  }
  __syncthreads();
  float* out = y + static_cast<size_t>(copy) * R * C;
  for (int i = ty; i < 32; i += kBlock / 32) {
    const int c = c0 + i, r = r0 + tx;
    if (r < R && c < C) out[static_cast<size_t>(c) * R + r] = tile[tx][i];
  }
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kBlock - 1) / kBlock);
}

}  // namespace

// lane_map: x f32 [rin, cin] (rin = rout / 2 for the row map, else rout),
// y f32 [copies, rout, cout]; form 0 gather, 1 shfl, 2 butterfly; map 0
// element, 1 tile, 2 pair, 3 row; p = log2 k (element, shfl, butterfly) or
// the tile length n (tile). The butterfly takes masks int32 [nst, cout],
// `shifts` (host, nst ints in [0, cout)) and tile_start (0: start from x,
// 1: from the tile of its first cout >> p columns). Returns
// cudaGetLastError().
extern "C" int expand_lane_map_launch(const void* x, void* y, int form,
                                      int map, int p, int cin, int rout,
                                      int cout, int copies,
                                      const void* masks, const int* shifts,
                                      int nst, int tile_start, void* stream) {
  if (cin < 1 || rout < 1 || cout < 1 || copies < 1 || map < kElement ||
      map > kRow)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto xs = static_cast<const float*>(x);
  const auto ys = static_cast<float*>(y);
  const auto m = static_cast<const int32_t*>(masks);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(copies) * rout * cout;
  Stages st{};
  switch (form) {
    case kGather:
      lane_map_kernel<kGather><<<blocks(total), kBlock, 0, s>>>(
          xs, ys, map, p, cin, rout, cout, total, m, st, 0, 0);
      break;
    case kShfl:
      if (map != kElement || p < 0 || p > 5 || cout % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      lane_map_kernel<kShfl><<<blocks(total), kBlock, 0, s>>>(
          xs, ys, map, p, cin, rout, cout, total, m, st, 0, 0);
      break;
    case kButterfly: {
      if (map != kElement || nst < 0 || nst > kMaxStages || p < 0 ||
          (nst > 0 && (masks == nullptr || shifts == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      for (int i = 0; i < nst; ++i) {
        if (shifts[i] < 0 || shifts[i] >= cout)
          return static_cast<int>(cudaErrorInvalidValue);
        st.shift[i] = shifts[i];
      }
      const size_t smem = 2 * static_cast<size_t>(cout) * sizeof(float);
      if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
      lane_map_kernel<kButterfly><<<copies * rout, kBlock, smem, s>>>(
          xs, ys, map, p, cin, rout, cout, total, m, st, nst, tile_start);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// transpose: x f32 [R, C], y f32 [copies, C, R]. Returns cudaGetLastError().
extern "C" int expand_transpose_launch(const void* x, void* y, int R, int C,
                                       int copies, void* stream) {
  if (R < 1 || C < 1 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tr = (R + 31) / 32, tc = (C + 31) / 32;
  transpose_kernel<<<copies * tr * tc, kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, C, tr, tc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
