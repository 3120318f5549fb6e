// One-hot selection products on the tensor cores of Hopper (sm_90a), with
// hand-written mma.sync.
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
//   tf32  mma.m16n8k8 tf32 with f32 accumulation, the counterpart of f32
//         DEFAULT. Both operands are rounded with cvt.rna.tf32.f32 first:
//         the low 13 bits of an unrounded register are implementation-
//         defined, and the plain version could not match them. TF32 keeps
//         11 significant bits, so it is exact only for such values.
//   bf16  mma.m16n8k16 bf16 with f32 accumulation; f32 inputs converted
//         with round-to-nearest-even.
//   u8x4  the exact route, the counterpart of HIGHEST: every 32-bit word of
//         X is split into 4 byte planes, each plane goes through
//         mma.m16n8k32.s32.u8.u8.s32, and Y = sum_b (X_b @ E) << 8b mod
//         2^32, which is X @ E mod 2^32 for any u8 E. For a one-hot E it
//         moves any 32-bit pattern bit for bit: int32 hashes, f32 payloads
//         with the sentinel, tiny and huge values, NaN bits.
//
// What bounds them on this card: at the probes' shapes, the output. Each
// of G copies writes its own [M, N] slot of 4-byte words (134 MB for P5's
// 256 copies) against 4.3e9 MACs, so the bytes bound lies above the
// tensor-core bound. The kernel itself is the simple one: mma.sync from
// registers loaded straight from global memory (L1 / L2 hits after the
// first copy), no shared-memory staging, no wgmma, no TMA; it is expected
// to stay well under the card's wgmma peak.
//
// What the design does: one warp per (copy, 16-row tile, 32-column tile):
// four m16n8 fragments side by side share each A fragment, and for u8x4
// each B fragment is loaded once and reused by the four byte planes. Every
// copy writes its own slot, so no copy's work can be dropped.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kNT = 4;  // m16n8 fragments per warp along N: 32 columns

enum Mode { kTf32 = 0, kBf16 = 1, kU8x4 = 2 };

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
__device__ __forceinline__ uint32_t plane(uint32_t w0, uint32_t w1,
                                          uint32_t w2, uint32_t w3, int b) {
  const int s = 8 * b;
  return ((w0 >> s) & 0xffu) | (((w1 >> s) & 0xffu) << 8) |
         (((w2 >> s) & 0xffu) << 16) | (((w3 >> s) & 0xffu) << 24);
}

template <int Mode>
__global__ void __launch_bounds__(kWarps * 32) onehot_mma_kernel(
    const void* __restrict__ xv, const void* __restrict__ ev,
    void* __restrict__ yv, int M, int K, int N, int tiles_m, int tiles_n,
    int64_t items) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  if (item >= items) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID
  const int t = lane & 3;   // thread in group
  const int per = tiles_m * tiles_n;
  const int64_t copy = item / per;
  const int rem = static_cast<int>(item % per);
  const int m0 = (rem / tiles_n) * 16;
  const int n0 = (rem % tiles_n) * (8 * kNT);
  const size_t r0 = static_cast<size_t>(m0 + g) * K;  // rows g and g + 8
  const size_t r8 = static_cast<size_t>(m0 + g + 8) * K;

  if constexpr (Mode == kU8x4) {
    const uint32_t* x = static_cast<const uint32_t*>(xv);
    const uint8_t* e = static_cast<const uint8_t*>(ev);
    int32_t acc[4][kNT][4] = {};
    for (int k0 = 0; k0 < K; k0 += 32) {
      // a0: row g, k0 + 4t + i; a1: row g + 8; a2, a3: the same + 16
      uint32_t w[4][4];
      for (int i = 0; i < 4; ++i) {
        w[0][i] = x[r0 + k0 + 4 * t + i];
        w[1][i] = x[r8 + k0 + 4 * t + i];
        w[2][i] = x[r0 + k0 + 16 + 4 * t + i];
        w[3][i] = x[r8 + k0 + 16 + 4 * t + i];
      }
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = n0 + nt * 8 + g;
        uint32_t b0 = 0, b1 = 0;  // k0 + 4t + i and k0 + 16 + 4t + i, col n
        for (int i = 0; i < 4; ++i) {
          b0 |= static_cast<uint32_t>(
                    e[static_cast<size_t>(k0 + 4 * t + i) * N + n])
                << (8 * i);
          b1 |= static_cast<uint32_t>(
                    e[static_cast<size_t>(k0 + 16 + 4 * t + i) * N + n])
                << (8 * i);
        }
        for (int b = 0; b < 4; ++b) {
          uint32_t a[4];
          for (int q = 0; q < 4; ++q)
            a[q] = plane(w[q][0], w[q][1], w[q][2], w[q][3], b);
          int32_t* c = acc[b][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
              : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                "r"(b1));
        }
      }
    }
    uint32_t* y = static_cast<uint32_t*>(yv) + copy * M * N;
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t v[4];
      for (int q = 0; q < 4; ++q)  // wraps mod 2^32, as the product does
        v[q] = static_cast<uint32_t>(acc[0][nt][q]) +
               (static_cast<uint32_t>(acc[1][nt][q]) << 8) +
               (static_cast<uint32_t>(acc[2][nt][q]) << 16) +
               (static_cast<uint32_t>(acc[3][nt][q]) << 24);
      const int n = n0 + nt * 8 + 2 * t;  // c0, c1: row g; c2, c3: g + 8
      y[static_cast<size_t>(m0 + g) * N + n] = v[0];
      y[static_cast<size_t>(m0 + g) * N + n + 1] = v[1];
      y[static_cast<size_t>(m0 + g + 8) * N + n] = v[2];
      y[static_cast<size_t>(m0 + g + 8) * N + n + 1] = v[3];
    }
  } else {
    const float* x = static_cast<const float*>(xv);
    const float* e = static_cast<const float*>(ev);
    float acc[kNT][4] = {};
    constexpr int kStep = Mode == kTf32 ? 8 : 16;
    for (int k0 = 0; k0 < K; k0 += kStep) {
      uint32_t a[4];
      if constexpr (Mode == kTf32) {
        // a0: (g, t), a1: (g + 8, t), a2: (g, t + 4), a3: (g + 8, t + 4)
        a[0] = tf32(x[r0 + k0 + t]);
        a[1] = tf32(x[r8 + k0 + t]);
        a[2] = tf32(x[r0 + k0 + t + 4]);
        a[3] = tf32(x[r8 + k0 + t + 4]);
      } else {
        // a0: (g, 2t, 2t + 1), a1: row g + 8, a2 and a3: columns + 8
        a[0] = bf16x2(x[r0 + k0 + 2 * t], x[r0 + k0 + 2 * t + 1]);
        a[1] = bf16x2(x[r8 + k0 + 2 * t], x[r8 + k0 + 2 * t + 1]);
        a[2] = bf16x2(x[r0 + k0 + 2 * t + 8], x[r0 + k0 + 2 * t + 9]);
        a[3] = bf16x2(x[r8 + k0 + 2 * t + 8], x[r8 + k0 + 2 * t + 9]);
      }
      for (int nt = 0; nt < kNT; ++nt) {
        const size_t n = n0 + nt * 8 + g;
        float* c = acc[nt];
        if constexpr (Mode == kTf32) {
          // b0: (k = t, n = g), b1: (k = t + 4, n = g)
          const uint32_t b0 = tf32(e[(k0 + t) * N + n]);
          const uint32_t b1 = tf32(e[(k0 + t + 4) * N + n]);
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                "r"(b1));
        } else {
          // b0: (k = 2t, 2t + 1; n = g), b1: k + 8
          const uint32_t b0 = bf16x2(e[(k0 + 2 * t) * N + n],
                                     e[(k0 + 2 * t + 1) * N + n]);
          const uint32_t b1 = bf16x2(e[(k0 + 2 * t + 8) * N + n],
                                     e[(k0 + 2 * t + 9) * N + n]);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                "r"(b1));
        }
      }
    }
    float* y = static_cast<float*>(yv) + copy * M * N;
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = n0 + nt * 8 + 2 * t;
      y[static_cast<size_t>(m0 + g) * N + n] = acc[nt][0];
      y[static_cast<size_t>(m0 + g) * N + n + 1] = acc[nt][1];
      y[static_cast<size_t>(m0 + g + 8) * N + n] = acc[nt][2];
      y[static_cast<size_t>(m0 + g + 8) * N + n + 1] = acc[nt][3];
    }
  }
}

}  // namespace

// onehot_mma: Y[c] = X @ E for c < copies. tf32 and bf16: x f32 [M, K],
// e f32 [K, N], y f32 [copies, M, N]; u8x4: x 32-bit words [M, K], e uint8
// [K, N], y 32-bit words [copies, M, N]. M a multiple of 16, N of 32, K of
// 8 (tf32), 16 (bf16) or 32 (u8x4). Returns cudaGetLastError().
extern "C" int mxu_onehot_launch(const void* x, const void* e, void* y,
                                 int mode, int M, int K, int N, int copies,
                                 void* stream) {
  const int kstep = mode == kTf32 ? 8 : mode == kBf16 ? 16 : 32;
  if (mode < kTf32 || mode > kU8x4 || M < 16 || M % 16 != 0 || N < 32 ||
      N % (8 * kNT) != 0 || K < kstep || K % kstep != 0 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tm = M / 16, tn = N / (8 * kNT);
  const int64_t items = static_cast<int64_t>(copies) * tm * tn;
  const int nb = static_cast<int>((items + kWarps - 1) / kWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kTf32:
      onehot_mma_kernel<kTf32><<<nb, kWarps * 32, 0, s>>>(x, e, y, M, K, N,
                                                          tm, tn, items);
      break;
    case kBf16:
      onehot_mma_kernel<kBf16><<<nb, kWarps * 32, 0, s>>>(x, e, y, M, K, N,
                                                          tm, tn, items);
      break;
    default:
      onehot_mma_kernel<kU8x4><<<nb, kWarps * 32, 0, s>>>(x, e, y, M, K, N,
                                                          tm, tn, items);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mxu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
