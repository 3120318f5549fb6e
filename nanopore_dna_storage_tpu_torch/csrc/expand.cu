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
//              loads its sources once and spreads them with __shfl_sync;
//   butterfly  the TPU formulation, carried over only so the card can time
//              it: the stages y = where(mask[s], roll(y, d_s), y) run with
//              the scripts' own shifts and masks (data-independent,
//              computed and packed as bits by the wrapper), in their order,
//              from the identity or from the tile of the prefix.
// transpose: [R, C] -> [C, R] through one shared-memory tile a block.
//
// What bounds them on this card: bytes. No form does arithmetic; a gather
// reads 4 B and writes 4 B per element, so at the scripts' shapes (8 to
// 64 KB) a launch is a few microseconds of latency, and with many copies
// the output writes to device memory bound it (268 MB for 4096 copies of
// [8, 2048] or 32,768 of [16, 128], 0.080 ms at 3.35 TB/s). The
// butterfly's stages are dependent: at one row per block its time is the
// chain of S stages, each a shuffle or a shared-memory round trip with a
// barrier.
//
// What the design does. Every form but the butterfly computes its values
// once, keeps them in registers and writes them to each copy of its share
// (the grid's third dimension, split so that one wave fills the card) as
// 16-byte streaming stores, with no index arithmetic in the copy loop.
// gather: a thread owns four neighbouring columns of one row (a 2-D grid,
// 32-bit indices) and loads their sources itself. shfl: a thread owns four
// neighbouring columns too, so a warp owns 128; the warp loads the 128 / k
// sources of its columns once, coalesced, one per lane per register, and
// each lane builds its four values by shuffles from the lanes that hold
// them. transpose: a block of 512 threads stages a tile of 2048 elements of
// x (all of [16, 128]) in shared memory once, with 16-byte loads where the
// rows allow them, XOR-swizzled so the transposed reads are free of bank
// conflicts; each thread then holds four neighbouring elements of one row
// of y; shapes that do not allow 16-byte accesses (R or C not a multiple
// of 4, or x unaligned) take 4-byte ones through the same tile. butterfly:
// one block of cout / 2 threads per (copy, row), the stage masks loaded
// into shared memory once as bits; the columns are laid out so that a roll
// by a multiple of cout / 32 is a lane rotation within each warp, taken
// with __shfl_sync and no barrier; the other rolls go through shared
// memory, one barrier each; the row leaves as 16-byte stores. Each of the
// `copies` copies writes its own output slot, as the TPU probes' grid
// steps each wrote theirs, so no copy's work can be dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxStages = 32;
constexpr int kMaxRow = 2048;  // butterfly: two columns a thread, 1024 threads
// resident blocks per SM a copy split aims at (2048 threads)
constexpr int kBlocksPerSm = 2048 / kBlock;
// transpose: the elements of x one block stages (8 KB), and its threads
constexpr int kTransposeTile = 2048;
constexpr int kTransposeThreads = kTransposeTile / 4;

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

// shfl, the element map y[g, r, j] = x[r, j >> P] (k = 2^P <= 32): warp
// w of the block owns the 128 columns base = 128 (8 blockIdx.x + w) ..
// base + 127 of row blockIdx.y, lane l the four at base + 4 l. The warp's
// 128 >> P sources x[r, (base >> P) + s] are loaded once, coalesced, one per
// lane per register: register i of lane l holds s = 32 i + l (kRegs = 4, 2,
// 1 registers for k = 1, 2, >= 4; lanes past the last source idle). A lane
// writes kRegs distinct values: value d has source s = (4 l >> P) + d, taken
// with __shfl_sync from lane s % 32 (one shuffle a register, the right one
// selected by s / 32 where k < 4); element e of the four is value e >> P.
// The four go to every copy blockIdx.z, + gridDim.z, ... as one 16-byte
// store. A row whose cout is not a multiple of 128 ends in a partial warp:
// its loads past the row and its stores past cout are masked.
template <int P>
__global__ void __launch_bounds__(kBlock) shfl_kernel(
    const float* __restrict__ x, float* __restrict__ y, int cin, int rout,
    int cout, int copies) {
  constexpr int kRegs = P >= 2 ? 1 : 4 >> P;
  const int lane = threadIdx.x & 31;
  const int base = 128 * (blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5));
  if (base >= cout) return;  // the whole warp: no lane of it shuffles
  const int r = blockIdx.y;
  const float* xr = x + static_cast<size_t>(r) * cin + (base >> P);
  const int nsrc = (cout - base < 128 ? cout - base : 128) >> P;
  float src[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const int s = 32 * i + lane;
    src[i] = s < nsrc ? __ldg(xr + s) : 0.0f;
  }
  float val[kRegs];
#pragma unroll
  for (int d = 0; d < kRegs; ++d) {
    const int s = ((4 * lane) >> P) + d;
    val[d] = __shfl_sync(0xffffffffu, src[0], s & 31);
#pragma unroll
    for (int i = 1; i < kRegs; ++i) {
      const float t = __shfl_sync(0xffffffffu, src[i], s & 31);
      val[d] = (s >> 5) == i ? t : val[d];
    }
  }
  const int j0 = base + 4 * lane;
  if (j0 >= cout) return;
  const float4 q = make_float4(val[0], val[1 >> P], val[2 >> P], val[3 >> P]);
  const size_t plane = static_cast<size_t>(rout) * cout;
  const size_t step = gridDim.z * plane;
  float* out = y + blockIdx.z * plane + static_cast<size_t>(r) * cout + j0;
  for (int c = blockIdx.z; c < copies; c += gridDim.z, out += step)
    __stcs(reinterpret_cast<float4*>(out), q);  // streamed: no reuse
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

// transpose: block b stages one tile of x, rows r0 .. r0 + TR - 1 and
// columns c0 .. c0 + TC - 1 (TC = 2048 / TR; b = tile row * tiles_c + tile
// column), in shared memory once: thread t loads the four neighbouring
// elements of tile row t / (TC / 4) at column 4 (t % (TC / 4)). Then thread
// t owns row c0 + t / G of y (G = TR / 4) and its elements r0 + 4 (t % G) ..
// + 3, read back from the tile as a column, and writes them to every copy
// blockIdx.z, + gridDim.z, ... A tile row's columns are stored XOR-swizzled
// by 128 / TR times the row's group of four, so a warp's column reads hit 32
// banks while each staged float4 stays whole. kVec: 16-byte loads and
// stores (R and C multiples of 4, x and y aligned); else 4-byte ones.
template <int TR, bool kVec>
__global__ void __launch_bounds__(kTransposeThreads) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ y, int R, int C,
    int tiles_c, int copies) {
  constexpr int TC = kTransposeTile / TR;
  constexpr int G = TR / 4;
  constexpr int kSwz = 128 / TR;  // G * kSwz = 32 banks
  __shared__ __align__(16) float tile[kTransposeTile];
  const int r0 = (blockIdx.x / tiles_c) * TR;
  const int c0 = (blockIdx.x % tiles_c) * TC;
  const int t = threadIdx.x;
  {
    const int i = t / (TC / 4), j = 4 * (t % (TC / 4));
    const int r = r0 + i, c = c0 + j;
    const float* src = x + static_cast<size_t>(r) * C + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kVec) {
      if (r < R && c < C) v = __ldg(reinterpret_cast<const float4*>(src));
    } else if (r < R) {
      if (c < C) v.x = __ldg(src);
      if (c + 1 < C) v.y = __ldg(src + 1);
      if (c + 2 < C) v.z = __ldg(src + 2);
      if (c + 3 < C) v.w = __ldg(src + 3);
    }
    *reinterpret_cast<float4*>(tile + i * TC + (j ^ ((i >> 2) * kSwz))) = v;
  }
  __syncthreads();
  const int g = t % G, j = t / G;
  const int r = r0 + 4 * g, c = c0 + j;
  if (r >= R || c >= C) return;
  const float* col = tile + 4 * g * TC + (j ^ (g * kSwz));
  const float4 q = make_float4(col[0], col[TC], col[2 * TC], col[3 * TC]);
  const size_t plane = static_cast<size_t>(R) * C;
  const size_t step = gridDim.z * plane;
  float* out = y + blockIdx.z * plane + static_cast<size_t>(c) * R + r;
  if (kVec) {
    for (int k = blockIdx.z; k < copies; k += gridDim.z, out += step)
      __stcs(reinterpret_cast<float4*>(out), q);  // streamed: no reuse
  } else {
    const int n = R - r;  // elements of the group inside y's row
    for (int k = blockIdx.z; k < copies; k += gridDim.z, out += step) {
      __stcs(out, q.x);
      if (n > 1) __stcs(out + 1, q.y);
      if (n > 2) __stcs(out + 2, q.z);
      if (n > 3) __stcs(out + 3, q.w);
    }
  }
}

// grid.z of a copy loop: how far to split `copies` so that one wave of
// `per_sm` resident blocks on every SM fills the card, `blocks` blocks a copy
unsigned copy_split(int64_t blocks, int per_sm, int copies) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t z = static_cast<int64_t>(sms) * per_sm / blocks;
  z = z < 1 ? 1 : z;
  z = z < copies ? z : copies;
  return static_cast<unsigned>(z < 65535 ? z : 65535);
}

template <int P>
void launch_shfl(dim3 grid, cudaStream_t s, const float* x, float* y, int cin,
                 int rout, int cout, int copies) {
  shfl_kernel<P><<<grid, kBlock, 0, s>>>(x, y, cin, rout, cout, copies);
}

template <int TR>
void launch_transpose(unsigned tiles, unsigned z, bool vec, cudaStream_t s,
                      const float* x, float* y, int R, int C, int tiles_c,
                      int copies) {
  const dim3 grid(tiles, 1, z);
  if (vec)
    transpose_kernel<TR, true><<<grid, kTransposeThreads, 0, s>>>(
        x, y, R, C, tiles_c, copies);
  else
    transpose_kernel<TR, false><<<grid, kTransposeThreads, 0, s>>>(
        x, y, R, C, tiles_c, copies);
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
      dim3 grid((cout / 4 + kBlock - 1) / kBlock, rout, 1);
      grid.z = copy_split(static_cast<int64_t>(grid.x) * grid.y,
                          kBlocksPerSm, copies);
      gather_kernel<<<grid, kBlock, 0, s>>>(xs, ys, map, p, cin, rout, cout,
                                            copies);
      break;
    }
    case kShfl: {
      if (map != kElement || p < 0 || p > 5 || cout % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      dim3 grid((cout + 128 * (kBlock / 32) - 1) / (128 * (kBlock / 32)),
                rout, 1);
      grid.z = copy_split(static_cast<int64_t>(grid.x) * grid.y,
                          kBlocksPerSm, copies);
      void (*const launch[])(dim3, cudaStream_t, const float*, float*, int,
                             int, int, int) = {
          launch_shfl<0>, launch_shfl<1>, launch_shfl<2>,
          launch_shfl<3>, launch_shfl<4>, launch_shfl<5>};
      launch[p](grid, s, xs, ys, cin, rout, cout, copies);
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

// transpose: x f32 [R, C], y f32 [copies, C, R], through tiles of `rows`
// (4, 8, 16 or 32) rows of x by 2048 / rows columns; vec 1 takes 16-byte
// loads and stores (R % 4 == 0, C % 4 == 0, x and y 16-byte aligned), vec 0
// 4-byte ones. Returns cudaGetLastError().
extern "C" int expand_transpose_launch(const void* x, void* y, int R, int C,
                                       int copies, int rows, int vec,
                                       void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (R < 1 || C < 1 || copies < 1 ||
      (rows != 4 && rows != 8 && rows != 16 && rows != 32) ||
      (vec && (R % 4 != 0 || C % 4 != 0 || !aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = kTransposeTile / rows;  // of x in one tile
  const int tiles_c = (C + cols - 1) / cols;
  const int64_t tiles = static_cast<int64_t>((R + rows - 1) / rows) * tiles_c;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned z = copy_split(tiles, 2048 / kTransposeThreads, copies);
  const auto xs = static_cast<const float*>(x);
  const auto ys = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<unsigned>(tiles);
  switch (rows) {
    case 4:
      launch_transpose<4>(n, z, vec, s, xs, ys, R, C, tiles_c, copies);
      break;
    case 8:
      launch_transpose<8>(n, z, vec, s, xs, ys, R, C, tiles_c, copies);
      break;
    case 16:
      launch_transpose<16>(n, z, vec, s, xs, ys, R, C, tiles_c, copies);
      break;
    default:
      launch_transpose<32>(n, z, vec, s, xs, ys, R, C, tiles_c, copies);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
