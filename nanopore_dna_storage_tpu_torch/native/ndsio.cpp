// Native host runtime of the PyTorch / CUDA port: the port's own copy of
// nanopore_dna_storage_tpu/native/ndsio.cpp, with the same C ABI and results.
//
// The reference pipeline's host-side work is scattered across C programs and
// python loops (temp-file .post shuffling in helper.py:211-224 /
// generate_decoded_lists.py, CRC in the python `crc8` package, Levenshtein in
// the python `distance` package). This library provides the hot host-side
// primitives as a small C ABI consumed via ctypes:
//
//   * nds_load_posts_batch: read + pad a batch of .post files (raw LE float32,
//     160 bytes/block) straight into a caller-provided buffer, with a
//     worker-thread pool: the input side of the host->device pipeline.
//   * nds_crc8_batch: table-based CRC8 (poly 0x07) over row-major byte rows.
//   * nds_levenshtein_windows: edit distance of a needle vs every length-w
//     window of a haystack (barcode scan of helper.py:157-209).
//
// Built with the system g++ at first use by native/__init__.py, into the
// checkout's build/native/ (no external deps).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// .post batch loading
// ---------------------------------------------------------------------------

// Load nfiles .post files into out[nfiles][max_blocks*40] (zero padded).
// nblocks_out[i] receives the block count of file i (or -1 on error).
// Returns 0 on success, first failing file index + 1 otherwise.
int nds_load_posts_batch(const char **paths, int nfiles, float *out,
                         long long max_blocks, long long *nblocks_out,
                         int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next(0), bad(0);
  const long long stride = max_blocks * 40;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= nfiles) return;
      nblocks_out[i] = -1;
      FILE *f = fopen(paths[i], "rb");
      if (!f) {
        bad.store(i + 1);
        continue;
      }
      fseek(f, 0, SEEK_END);
      long long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      if (sz % 160 != 0 || sz / 160 > max_blocks) {
        fclose(f);
        bad.store(i + 1);
        continue;
      }
      float *dst = out + (long long)i * stride;
      memset(dst, 0, stride * sizeof(float));
      size_t got = fread(dst, 1, (size_t)sz, f);
      fclose(f);
      if ((long long)got != sz) {
        bad.store(i + 1);
        continue;
      }
      nblocks_out[i] = sz / 160;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
  return bad.load();
}

// ---------------------------------------------------------------------------
// CRC8 (poly 0x07, init 0) over rows of a [nrows, rowlen] byte matrix
// ---------------------------------------------------------------------------

static uint8_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (int b = 0; b < 256; b++) {
    uint8_t c = (uint8_t)b;
    for (int k = 0; k < 8; k++)
      c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
    crc_table[b] = c;
  }
  crc_init_done = true;
}

void nds_crc8_batch(const uint8_t *rows, long long nrows, long long rowlen,
                    uint8_t *out) {
  if (!crc_init_done) crc_init();
  for (long long r = 0; r < nrows; r++) {
    uint8_t c = 0;
    const uint8_t *p = rows + r * rowlen;
    for (long long j = 0; j < rowlen; j++) c = crc_table[c ^ p[j]];
    out[r] = c;
  }
}

// ---------------------------------------------------------------------------
// Levenshtein window scan
// ---------------------------------------------------------------------------

// dist_out[i] = levenshtein(needle, haystack[starts[i] .. starts[i]+wlen))
void nds_levenshtein_windows(const char *needle, int nlen,
                             const char *haystack, const int *starts,
                             int nstarts, int wlen, int *dist_out) {
  std::vector<int> prev(wlen + 1), curr(wlen + 1);
  for (int s = 0; s < nstarts; s++) {
    const char *win = haystack + starts[s];
    for (int j = 0; j <= wlen; j++) prev[j] = j;
    for (int i = 1; i <= nlen; i++) {
      curr[0] = i;
      const char nc = needle[i - 1];
      for (int j = 1; j <= wlen; j++) {
        int sub = prev[j - 1] + (win[j - 1] != nc);
        int del = prev[j] + 1;
        int ins = curr[j - 1] + 1;
        int m = sub < del ? sub : del;
        curr[j] = m < ins ? m : ins;
      }
      std::swap(prev, curr);
    }
    dist_out[s] = prev[wlen];
  }
}

}  // extern "C"
