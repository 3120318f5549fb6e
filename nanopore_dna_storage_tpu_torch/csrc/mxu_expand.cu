// One-hot selection products on the tensor cores of Hopper (sm_90a), with
// hand-written wgmma from shared memory.
//
// Replaces the Pallas TPU probes of scripts/ that expand y[j] = x[j >> 2]
// on the TPU's matrix unit as Y = X @ E with a dense 0/1 matrix E:
// - tpu_mxu_expand_probe.py `kernel` (pallas_call in `main`, :53):
//   f32 [256, 128] @ [128, 512] at HIGHEST, int32 hashes as 16-bit halves;
// - tpu_mxu_probe2.py `bench` (pallas_call at :33): the same product at 8
//   (rows, K, CT, precision, dtype) points;
// - tpu_mxu_probe3.py `main` (pallas_call at :43): f32 payloads
//   [320, 128] @ [128, 512], the -2^127 sentinel, bit-exactness.
// The plain PyTorch version is probes/mxu_expand.py `onehot_mma_ref`.
//
// Modes:
//   tf32  wgmma m64nNk8 tf32 with f32 accumulation, the counterpart of f32
//         DEFAULT. Both operands are rounded with cvt.rna.tf32.f32 as they
//         are staged: the low 13 bits of an unrounded operand are
//         implementation-defined, and the plain version could not match
//         them. TF32 keeps 11 significant bits, so it is exact only for such
//         values.
//   bf16  wgmma m64nNk16 bf16 with f32 accumulation; f32 inputs converted
//         with round-to-nearest-even as they are staged.
//   u8x4  the exact route, the counterpart of HIGHEST: every 32-bit word of
//         X is split into 4 byte planes, each plane goes through wgmma
//         m64nNk32 s32.u8.u8, and Y = sum_b (X_b @ E) << 8b mod 2^32, which
//         is X @ E mod 2^32 for any u8 E. For a one-hot E it moves any
//         32-bit pattern bit for bit: int32 hashes, f32 payloads with the
//         sentinel, tiny and huge values, NaN bits.
//
// What bounds them on this card: at K = 128 (P5, P7, half of P6) the
// output. Each of G copies writes its own [M, N] slot of 4-byte words (134
// MB for P5's 256 copies, 0.040 ms at 3.35 TB/s) against 4.3e9 MACs (0.017
// ms of TF32 tensor time). At K = 512 the tensor cores: P6's [256, 512] @
// [512, 512] x 256 is 0.069 ms of TF32 against 0.040 ms of bytes.
//
// What the design does: persistent blocks, one per SM, of one warpgroup.
// A block walks over a contiguous range of (64-row tile, TN-column tile,
// copy) items, tile-major, so it stages a tile's operands into shared
// memory once, converted as the mode needs (E transposed to [TN, K], since
// wgmma takes tf32 and 8-bit operands K-major only), and reuses them for
// every copy it writes. The whole K stays resident: TN (128, 64 or 32) is
// the widest that fits beside X and two output buffers. Each copy gets its
// own wgmma chain (asm volatile, so no copy's work can be dropped or
// hoisted; u8x4's four planes each into their own accumulators, one wait
// for all). The accumulators go to a padded shared-memory buffer, and the
// tile leaves from there as 16-byte streaming stores by all 128 threads,
// a warp on neighbouring addresses, while the next copy's wgmma runs (two
// buffers, one barrier a copy). One cp.async.bulk copy per 512-byte row
// was tried first: the bulk copies, not the product, then set the time.
// Operands use the no-swizzle K-major core-matrix layout: 8 rows x 16
// bytes contiguous, the core matrices along K 128 bytes apart (LBO), the
// 8-row groups K * bytes * 8 apart (SBO).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTM = 64;        // rows per tile: wgmma's M
constexpr int kPad = 8;        // floats after each staged output row
constexpr int kMaxSmem = 232448;

enum Mode { kTf32 = 0, kBf16 = 1, kU8x4 = 2 };

// bytes of one K element as staged, and the planes of X
__host__ __device__ constexpr int elem_bytes(int mode) {
  return mode == kTf32 ? 4 : mode == kBf16 ? 2 : 1;
}
__host__ __device__ constexpr int planes(int mode) {
  return mode == kU8x4 ? 4 : 1;
}

// dynamic shared memory of one block: X planes, E^T, two output buffers
size_t smem_bytes(int mode, int K, int tn) {
  const size_t kb = static_cast<size_t>(K) * elem_bytes(mode);
  return (planes(mode) * kTM + tn) * kb +
         2 * static_cast<size_t>(kTM) * (tn + kPad) * sizeof(float);
}

template <int Mode>
using Acc = typename std::conditional<Mode == kU8x4, int32_t, float>::type;

// D (+)= A @ B for one 64 x TN x 32-byte step, A and B from shared memory
template <int Mode, int TN>
__device__ void wgmma(Acc<Mode> (&d)[TN / 2], uint64_t a, uint64_t b,
                      int scale_d);

#define REGS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, " \
               "%13, %14, %15"
#define REGS32 REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, " \
               "%25, %26, %27, %28, %29, %30, %31"
#define REGS64 REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
               "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
               "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define ACC4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define ACC16(c, i) ACC4(c, i), ACC4(c, i + 4), ACC4(c, i + 8), \
                    ACC4(c, i + 12)
#define ACC32(c, i) ACC16(c, i), ACC16(c, i + 16)
#define ACC64(c, i) ACC32(c, i), ACC32(c, i + 32)
// ACCS: the accumulators as operands; AB and SC: the operand numbers of
// the two descriptors and of scale-d; TAIL: the immediates after scale-d
#define WGMMA(MODE, TN, SHAPE, TAIL, REGS, ACCS, AB, SC)                    \
  template <>                                                               \
  __device__ __forceinline__ void wgmma<MODE, TN>(                          \
      Acc<MODE>(&d)[TN / 2], uint64_t a, uint64_t b, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned." SHAPE " {" REGS "}, " AB  \
                 ", p" TAIL ";\n}\n"                                        \
                 : ACCS                                                     \
                 : "l"(a), "l"(b), "r"(scale_d));                           \
  }
#define TF32 ", 1, 1"
#define BF16 ", 1, 1, 0, 0"
WGMMA(kTf32, 128, "m64n128k8.f32.tf32.tf32", TF32, REGS64,
      ACC64("+f", 0), "%64, %65", "%66")
WGMMA(kTf32, 64, "m64n64k8.f32.tf32.tf32", TF32, REGS32, ACC32("+f", 0),
      "%32, %33", "%34")
WGMMA(kTf32, 32, "m64n32k8.f32.tf32.tf32", TF32, REGS16, ACC16("+f", 0),
      "%16, %17", "%18")
WGMMA(kBf16, 128, "m64n128k16.f32.bf16.bf16", BF16, REGS64,
      ACC64("+f", 0), "%64, %65", "%66")
WGMMA(kBf16, 64, "m64n64k16.f32.bf16.bf16", BF16, REGS32, ACC32("+f", 0),
      "%32, %33", "%34")
WGMMA(kBf16, 32, "m64n32k16.f32.bf16.bf16", BF16, REGS16, ACC16("+f", 0),
      "%16, %17", "%18")
WGMMA(kU8x4, 64, "m64n64k32.s32.u8.u8", "", REGS32, ACC32("+r", 0),
      "%32, %33", "%34")
WGMMA(kU8x4, 32, "m64n32k32.s32.u8.u8", "", REGS16, ACC16("+r", 0),
      "%16, %17", "%18")

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// no-swizzle K-major descriptor: start, LBO 128 bytes (the next core
// matrix along K), SBO the next 8-row group; all in 16-byte units
__device__ __forceinline__ uint64_t descriptor(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte b of each of four words, the first word in the low byte
__device__ __forceinline__ uint32_t plane(uint4 w, int b) {
  const int s = 8 * b;
  return ((w.x >> s) & 0xffu) | (((w.y >> s) & 0xffu) << 8) |
         (((w.z >> s) & 0xffu) << 16) | (((w.w >> s) & 0xffu) << 24);
}

// Stage X rows m0.. of the tile: chunk i of 16 staged bytes is row
// 8 (i / (8 kc)) + i % 8, K chunk (i / 8) % kc, and lies at byte 16 i, the
// core-matrix layout; kc = 16-byte chunks per row.
template <int Mode>
__device__ void stage_x(const void* __restrict__ xv, uint8_t* a, int m0,
                        int K) {
  constexpr int eb = elem_bytes(Mode);
  const int kc = K * eb / 16, per = 16 / eb;  // per: K elements a chunk
  const int chunks = kTM * kc;
#pragma unroll 4
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int r = 8 * (i / (8 * kc)) + (i & 7);
    const int k = ((i >> 3) % kc) * per;
    const size_t at = static_cast<size_t>(m0 + r) * K + k;
    if constexpr (Mode == kU8x4) {  // 16 words: one chunk in each plane
      const uint4* w = reinterpret_cast<const uint4*>(
          static_cast<const uint32_t*>(xv) + at);
      const uint4 w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        reinterpret_cast<uint4*>(a + p * kTM * K)[i] =
            make_uint4(plane(w0, p), plane(w1, p), plane(w2, p),
                       plane(w3, p));
    } else if constexpr (Mode == kTf32) {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const float*>(xv) + at);
      reinterpret_cast<uint4*>(a)[i] =
          make_uint4(tf32(f.x), tf32(f.y), tf32(f.z), tf32(f.w));
    } else {
      const float4* f = reinterpret_cast<const float4*>(
          static_cast<const float*>(xv) + at);
      const float4 f0 = f[0], f1 = f[1];
      reinterpret_cast<uint4*>(a)[i] =
          make_uint4(bf16x2(f0.x, f0.y), bf16x2(f0.z, f0.w),
                     bf16x2(f1.x, f1.y), bf16x2(f1.z, f1.w));
    }
  }
}

// Stage E^T: row n of the B tile is column n0 + n of E [K, N], laid out
// as stage_x lays out X (neighbouring threads on neighbouring columns).
template <int Mode, int TN>
__device__ void stage_e(const void* __restrict__ ev, uint8_t* b, int n0,
                        int K, int N) {
  constexpr int eb = elem_bytes(Mode);
  const int kc = K * eb / 16, per = 16 / eb;
  const int chunks = TN * kc;
#pragma unroll 4
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int n = n0 + 8 * (i / (8 * kc)) + (i & 7);
    const int k = ((i >> 3) % kc) * per;
    uint32_t w[4];
    if constexpr (Mode == kU8x4) {
      const uint8_t* e = static_cast<const uint8_t*>(ev) + n;
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
        for (int t = 0; t < 4; ++t)
          w[q] |= static_cast<uint32_t>(
                      e[static_cast<size_t>(k + 4 * q + t) * N])
                  << (8 * t);
      }
    } else {
      const float* e = static_cast<const float*>(ev) + n;
      for (int q = 0; q < 4; ++q) {
        if constexpr (Mode == kTf32) {
          w[q] = tf32(e[static_cast<size_t>(k + q) * N]);
        } else {
          w[q] = bf16x2(e[static_cast<size_t>(k + 2 * q) * N],
                        e[static_cast<size_t>(k + 2 * q + 1) * N]);
        }
      }
    }
    reinterpret_cast<uint4*>(b)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int Mode, int TN>
__global__ void __launch_bounds__(kThreads, 1) onehot_wgmma_kernel(
    const void* __restrict__ xv, const void* __restrict__ ev,
    void* __restrict__ yv, int M, int K, int N, int copies) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kNR = TN / 2;  // accumulator registers a thread
  constexpr int kRow = TN + kPad;
  const int kb = K * elem_bytes(Mode);  // staged bytes of one row
  uint8_t* a_s = smem;                  // planes x [64, K]
  uint8_t* b_s = a_s + planes(Mode) * kTM * kb;  // [TN, K]
  float* out_s = reinterpret_cast<float*>(b_s + TN * kb);  // 2 x [64, kRow]
  const int tid = threadIdx.x;
  const int tiles_n = N / TN;
  const int64_t items =
      static_cast<int64_t>(M / kTM) * tiles_n * copies;
  const int64_t first = items * blockIdx.x / gridDim.x;
  const int64_t last = items * (blockIdx.x + 1) / gridDim.x;
  const int steps = kb / 32;  // wgmma k-steps of 32 bytes
  const int sbo = kb * 8;
  // accumulator layout: row 16 warp + lane / 4 (+ 8), column 8 j + 2
  // (lane % 4) (+ 1) for the registers 4 j .. 4 j + 3
  const int row = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int col = 2 * (tid & 3);
  int staged = -1;
  int buf = 0;
  // the item whose tile waits in buffer buf ^ 1 to be stored: where its
  // rows go (null: none yet)
  float* pending = nullptr;
  // all 128 threads store a tile, 16 bytes each, a warp's stores on
  // neighbouring addresses of a row
  const auto store = [&](float* dst, const float* src) {
#pragma unroll
    for (int q = 0; q < kTM * TN / 4 / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (TN / 4), c = 4 * (i % (TN / 4));
      __stcs(reinterpret_cast<float4*>(dst + static_cast<int64_t>(r) * N + c),
             *reinterpret_cast<const float4*>(src + r * kRow + c));
    }
  };
  for (int64_t it = first; it < last; ++it, buf ^= 1) {
    const int tile = static_cast<int>(it / copies);
    const int64_t copy = it % copies;
    const int m0 = (tile / tiles_n) * kTM, n0 = (tile % tiles_n) * TN;
    if (tile != staged) {
      // the last tile's stores leave while the new operands arrive
      if (pending != nullptr)
        store(pending, out_s + (buf ^ 1) * kTM * kRow);
      pending = nullptr;
      __syncthreads();  // every wgmma on the old operands has completed
      stage_x<Mode>(xv, a_s, m0, K);
      stage_e<Mode, TN>(ev, b_s, n0, K, N);
      fence_async_smem();
      __syncthreads();
      staged = tile;
    }
    // one accumulator set per plane, so that the planes' chains run back
    // to back. Left undefined: the first k-step overwrites them (scale-d
    // 0), and any other instruction that defined them would serialize the
    // wgmma pipeline; dead outside an item, so staging does not hold them.
    Acc<Mode> acc[planes(Mode)][kNR];
    const uint64_t db = descriptor(b_s, sbo);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < planes(Mode); ++p) {
      const uint64_t da = descriptor(a_s + p * kTM * kb, sbo);
      for (int s = 0; s < steps; ++s)  // 256 bytes = 16 units a step
        wgmma<Mode, TN>(acc[p], da + 16 * s, db + 16 * s, s);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous item's tile leaves while this product runs
    if (pending != nullptr) store(pending, out_s + (buf ^ 1) * kTM * kRow);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // the word at accumulator register i: u8x4 sums its planes shifted by
    // 8 b, wrapping mod 2^32 as the product does
    const auto word = [&](int i) {
      if constexpr (Mode == kU8x4) {
        return __uint_as_float(static_cast<uint32_t>(acc[0][i]) +
                               (static_cast<uint32_t>(acc[1][i]) << 8) +
                               (static_cast<uint32_t>(acc[2][i]) << 16) +
                               (static_cast<uint32_t>(acc[3][i]) << 24));
      } else {
        return acc[0][i];
      }
    };
    // buffer buf was last read by the stores of two items ago, which every
    // thread finished before the last barrier
    float* out = out_s + buf * kTM * kRow;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      *reinterpret_cast<float2*>(out + row * kRow + 8 * j + col) =
          make_float2(word(4 * j), word(4 * j + 1));
      *reinterpret_cast<float2*>(out + (row + 8) * kRow + 8 * j + col) =
          make_float2(word(4 * j + 2), word(4 * j + 3));
    }
    __syncthreads();
    pending = static_cast<float*>(yv) +
              (copy * M + m0) * static_cast<int64_t>(N) + n0;
  }
  if (pending != nullptr) store(pending, out_s + (buf ^ 1) * kTM * kRow);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int Mode, int TN>
cudaError_t launch(const void* x, const void* e, void* y, int M, int K,
                   int N, int copies, cudaStream_t s) {
  const auto kernel = onehot_wgmma_kernel<Mode, TN>;
  const size_t smem = smem_bytes(Mode, K, TN);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  const int64_t items =
      static_cast<int64_t>(M / kTM) * (N / TN) * copies;
  const int sms = sm_count();
  const int nb = static_cast<int>(items < sms ? items : sms);
  kernel<<<nb, kThreads, smem, s>>>(x, e, y, M, K, N, copies);
  return cudaGetLastError();
}

template <int Mode>
cudaError_t launch_mode(int tn, const void* x, const void* e, void* y,
                        int M, int K, int N, int copies, cudaStream_t s) {
  switch (tn) {
    case 128:
      if constexpr (Mode != kU8x4)  // never built: it would spill
        return launch<Mode, 128>(x, e, y, M, K, N, copies, s);
      return cudaErrorInvalidValue;
    case 64:
      return launch<Mode, 64>(x, e, y, M, K, N, copies, s);
    default:
      return launch<Mode, 32>(x, e, y, M, K, N, copies, s);
  }
}

}  // namespace

// The column tile onehot_mma takes for (mode, K, N): the widest of 128, 64
// and 32 that divides N and fits in shared memory with the whole K, or 0.
// u8x4 stops at 64: its four planes' accumulators take 4 x 32 registers a
// thread there, and would take 256 at 128 columns.
extern "C" int mxu_onehot_tile_n(int mode, int K, int N) {
  if (mode < kTf32 || mode > kU8x4 || K < 32 || K % 32 != 0) return 0;
  for (int tn : {128, 64, 32})
    if ((mode != kU8x4 || tn <= 64) && N % tn == 0 &&
        smem_bytes(mode, K, tn) <= kMaxSmem)
      return tn;
  return 0;
}

// onehot_mma: Y[c] = X @ E for c < copies. tf32 and bf16: x f32 [M, K],
// e f32 [K, N], y f32 [copies, M, N]; u8x4: x 32-bit words [M, K], e uint8
// [K, N], y 32-bit words [copies, M, N]. M a multiple of 64, K of 32 and N
// of 32, with a column tile (mxu_onehot_tile_n) that fits. Returns
// cudaGetLastError().
extern "C" int mxu_onehot_launch(const void* x, const void* e, void* y,
                                 int mode, int M, int K, int N, int copies,
                                 void* stream) {
  const int tn = mxu_onehot_tile_n(mode, K, N);
  if (tn == 0 || M < kTM || M % kTM != 0 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kTf32:
      err = launch_mode<kTf32>(tn, x, e, y, M, K, N, copies, s);
      break;
    case kBf16:
      err = launch_mode<kBf16>(tn, x, e, y, M, K, N, copies, s);
      break;
    default:
      err = launch_mode<kU8x4>(tn, x, e, y, M, K, N, copies, s);
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* mxu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
