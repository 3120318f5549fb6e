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
// in three forms (one kernel each):
//   gather     every thread loads its own sources;
//   shfl       the element map only, k a power of two up to 32: each warp
//              loads its 32 / k sources once and spreads them with
//              __shfl_sync;
//   butterfly  the TPU formulation, carried over only so the card can time
//              it: the stages y = where(mask[s], roll(y, d_s), y) run with
//              the scripts' own shifts and masks (data-independent,
//              computed and packed as bits by the wrapper), in their order,
//              from the identity or from the tile of the prefix.
// transpose: [R, C] -> [C, R] through a 32 x 33 shared-memory tile.
//
// What bounds them on this card: bytes. No form does arithmetic; a gather
// reads 4 B and writes 4 B per element, so at the scripts' shapes (32 to
// 64 KB) a launch is a few microseconds of latency, and with many copies
// the output writes to device memory bound it (268 MB for 4096 copies of
// [8, 2048], 0.080 ms at 3.35 TB/s). The butterfly's stages are
// dependent: at one row per block its time is the chain of S stages, each
// a shuffle or a shared-memory round trip with a barrier.
//
// What the design does. gather: a thread owns four neighbouring columns of
// one row (a 2-D grid, 32-bit indices), loads their sources once and
// writes them to each copy of its share (the grid's third dimension) as
// one 16-byte store, so a warp writes 512 contiguous bytes per copy with
// no index arithmetic in the loop. butterfly: one block of cout / 2
// threads per (copy, row), the stage masks loaded into shared memory once
// as bits; the columns are laid out so that a roll by a multiple of cout /
// 32 is a lane rotation within each warp, taken with __shfl_sync and no
// barrier; the other rolls go through shared memory, one barrier each; the
// row leaves as 16-byte stores. shfl: one thread per output element. Each
// of the `copies` copies writes its own output slot, as the TPU probes'
// grid steps each wrote theirs, so no copy's work can be dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxStages = 32;
constexpr int kMaxRow = 2048;  // butterfly: two columns a thread, 1024 threads
// resident gather blocks per SM the copy split aims at (2048 threads)
constexpr int kGatherBlocksPerSm = 2048 / kBlock;

enum Form { kGather = 0, kShfl = 1, kButterfly = 2 };
enum Map { kElement = 0, kTile = 1, kPair = 2, kRow = 3 };

// shift[s]: the roll of stage s; lanes[s]: shift[s] / span when the shift
// is a whole number of spans (a rotation of the lanes), else -1
struct Stages {
  int shift[kMaxStages];
  int lanes[kMaxStages];
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

// gather: thread (blockIdx.x, threadIdx.x) owns columns j0 .. j0 + 3 of row
// blockIdx.y; it loads their sources once, then writes them as one 16-byte
// store to every copy blockIdx.z, + gridDim.z, ...
__global__ void __launch_bounds__(kBlock) gather_kernel(
    const float* __restrict__ x, float* __restrict__ y, int map, int p,
    int cin, int rout, int cout, int copies) {
  const int j0 = 4 * (blockIdx.x * kBlock + threadIdx.x);
  if (j0 >= cout) return;
  const int r = blockIdx.y;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int sr, sc;
    source(map, p, r, j0 + i, sr, sc);
    v[i] = x[sr * cin + sc];
  }
  const float4 q = make_float4(v[0], v[1], v[2], v[3]);
  const size_t plane = static_cast<size_t>(rout) * cout;
  const size_t step = gridDim.z * plane;
  float* out = y + blockIdx.z * plane + r * cout + j0;
  for (int c = blockIdx.z; c < copies; c += gridDim.z, out += step)
    __stcs(reinterpret_cast<float4*>(out), q);  // streamed: no reuse
}

// shfl, the element map: one thread per output element t of [copies,
// rout, cout]; each warp loads its 32 / k sources once and spreads them
__global__ void __launch_bounds__(kBlock) shfl_kernel(
    const float* __restrict__ x, float* __restrict__ y, int p, int cin,
    int rout, int cout, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // total is a multiple of 32, so whole warps leave together
  if (t >= total) return;
  const int per = rout * cout;
  const int e = static_cast<int>(t % per);
  const int r = e / cout;
  const int j = e % cout;
  const int lane = threadIdx.x & 31;
  const int j0 = j - lane;  // the warp's first column, same row
  float v = 0.0f;
  if (lane < (32 >> p))
    v = x[static_cast<size_t>(r) * cin + (j0 >> p) + lane];
  y[t] = __shfl_sync(0xffffffffu, v, lane >> p);
}

// shared-memory index of column j: one float of padding after every 32
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// butterfly: one block per (copy, row) of cout / 2 threads. Thread (warp w,
// lane l) holds columns j = span l + 2 w and j + 1, span = cout / 32, so a
// roll by a whole number of spans is a rotation of the lanes within every
// warp (__shfl_sync, no barrier); any other roll goes through a shared-
// memory buffer and one barrier, the two buffers taken in turn. The
// stages' masks arrive as bits (bit j % 32 of word j / 32), copied to
// shared memory in one pass.
__global__ void __launch_bounds__(kMaxRow / 2) butterfly_kernel(
    const float* __restrict__ x, float* __restrict__ y, int p, int cin,
    int rout, int cout, const uint32_t* __restrict__ bits, Stages st,
    int nst, int tile_start) {
  extern __shared__ uint32_t sm[];
  const int words = cout >> 5;
  uint32_t* mbits = sm;
  float* buf = reinterpret_cast<float*>(sm + nst * words);
  const int stride = padded(cout);  // floats of one buffer
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = words * lane + 2 * (tid >> 5);  // span = words
  for (int i = tid; i < nst * words; i += blockDim.x) mbits[i] = bits[i];
  const float* xr = x + static_cast<size_t>(blockIdx.x % rout) * cin;
  const int n = cout >> p;
  float v0 = xr[tile_start ? j % n : j];
  float v1 = xr[tile_start ? (j + 1) % n : j + 1];
  __syncthreads();
  int b = 0;
  for (int s = 0; s < nst; ++s) {
    // roll(y, d)[j] = y[(j - d) mod cout], as jnp.roll and pltpu.roll
    const uint32_t m = mbits[s * words + (j >> 5)] >> (j & 31);
    float r0, r1;
    if (st.lanes[s] >= 0) {
      const int src = (lane - st.lanes[s]) & 31;
      r0 = __shfl_sync(0xffffffffu, v0, src);
      r1 = __shfl_sync(0xffffffffu, v1, src);
    } else {
      float* cur = buf + b * stride;
      b ^= 1;
      cur[padded(j)] = v0;
      cur[padded(j + 1)] = v1;
      __syncthreads();
      const int d = st.shift[s];
      const int s0 = j >= d ? j - d : j - d + cout;
      r0 = cur[padded(s0)];
      r1 = cur[padded(s0 + 1 == cout ? 0 : s0 + 1)];
    }
    v0 = m & 1u ? r0 : v0;
    v1 = m & 2u ? r1 : v1;
  }
  // leave through shared memory as 16-byte stores of neighbouring columns
  float* cur = buf + b * stride;
  cur[padded(j)] = v0;
  cur[padded(j + 1)] = v1;
  __syncthreads();
  if (4 * tid < cout) {
    const int c = 4 * tid;
    const float4 q = make_float4(cur[padded(c)], cur[padded(c + 1)],
                                 cur[padded(c + 2)], cur[padded(c + 3)]);
    *reinterpret_cast<float4*>(y + static_cast<size_t>(blockIdx.x) * cout +
                               c) = q;
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
// the tile length n (tile). gather takes cout % 4 == 0, shfl cout % 32 ==
// 0. The butterfly (64 <= cout <= 2048, cout % 64 == 0) takes the stage
// masks as bits, int32 [nst, cout / 32] (bit j % 32 of word j / 32 for
// column j), `shifts` (host, nst ints in [0, cout)) and tile_start (0:
// start from x, 1: from the tile of its first cout >> p columns). Returns
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
  const auto s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kGather: {
      if (cout % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      dim3 grid((cout / 4 + kBlock - 1) / kBlock, rout, 1);
      // split the copies so that one wave of resident blocks fills the card
      const int64_t want = static_cast<int64_t>(sms) * kGatherBlocksPerSm /
                           (static_cast<int64_t>(grid.x) * grid.y);
      int64_t z = want < 1 ? 1 : want;
      z = z < copies ? z : copies;
      grid.z = static_cast<unsigned>(z < 65535 ? z : 65535);
      gather_kernel<<<grid, kBlock, 0, s>>>(xs, ys, map, p, cin, rout, cout,
                                            copies);
      break;
    }
    case kShfl: {
      if (map != kElement || p < 0 || p > 5 || cout % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const int64_t total = static_cast<int64_t>(copies) * rout * cout;
      shfl_kernel<<<blocks(total), kBlock, 0, s>>>(xs, ys, p, cin, rout,
                                                   cout, total);
      break;
    }
    case kButterfly: {
      if (map != kElement || nst < 0 || nst > kMaxStages || p < 0 ||
          cout < 64 || cout > kMaxRow || cout % 64 != 0 || (cout >> p) < 1 ||
          (nst > 0 && (masks == nullptr || shifts == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      Stages st{};
      const int span = cout / 32;
      for (int i = 0; i < nst; ++i) {
        if (shifts[i] < 0 || shifts[i] >= cout)
          return static_cast<int>(cudaErrorInvalidValue);
        st.shift[i] = shifts[i];
        st.lanes[i] = shifts[i] % span == 0 ? shifts[i] / span : -1;
      }
      const size_t smem = (static_cast<size_t>(nst) * (cout / 32) +
                           2 * static_cast<size_t>(cout + cout / 32)) *
                          sizeof(float);
      butterfly_kernel<<<copies * rout, cout / 2, smem, s>>>(
          xs, ys, p, cin, rout, cout, static_cast<const uint32_t*>(masks),
          st, nst, tile_start);
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
