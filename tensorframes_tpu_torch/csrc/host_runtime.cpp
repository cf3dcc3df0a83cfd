/* host_runtime: the host side of the port's data path.
 *
 * The threaded loops around every host->device copy: dtype conversion,
 * row gather (a keyed aggregate's sort by key), ragged-cell packing (CSR
 * and pad-to-dense) and a pooled, 64-byte-aligned allocator for staging
 * buffers. The port's counterpart of the JAX package's native runtime
 * core, with the same plain C interface; bound with ctypes by
 * tensorframes_tpu_torch/native.py, which falls back to numpy when the
 * library cannot be built or TFT_DISABLE_NATIVE=1 is set.
 *
 * Built at first use by tensorframes_tpu_torch/ops/_build.py:
 *   g++ -O3 -std=c++17 -fPIC -pthread -shared host_runtime.cpp
 * into build/kernels/libhost_runtime-<hash>.so. No dependency but the C++
 * standard library.
 */

#include <stdint.h>

#include <atomic>
#include <cstring>
#include <map>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

/* dtype codes (stable ABI; mirrored by native._DTYPE_CODES) */
enum tfr_dtype {
  TFR_F32 = 0,
  TFR_F64 = 1,
  TFR_I32 = 2,
  TFR_I64 = 3,
  TFR_U8 = 4,
};

namespace {

std::atomic<int> g_threads{0}; /* 0 = unset -> hardware default */

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

int threads_for(int64_t work_bytes) {
  int t = g_threads.load(std::memory_order_relaxed);
  if (t <= 0) t = hw_threads();
  /* below ~1 MiB the spawn cost dwarfs the win */
  if (work_bytes < (1 << 20)) return 1;
  int64_t max_by_work = work_bytes / (1 << 19);
  if (max_by_work < t) t = static_cast<int>(max_by_work);
  return t < 1 ? 1 : t;
}

/* Run fn(begin, end) over [0, n) split across threads. */
template <typename F>
void parallel_for(int64_t n, int64_t bytes_per_item, F &&fn) {
  int t = threads_for(n * bytes_per_item);
  if (t <= 1 || n < t) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  int64_t chunk = (n + t - 1) / t;
  for (int i = 1; i < t; ++i) {
    int64_t a = i * chunk, b = a + chunk < n ? a + chunk : n;
    if (a >= b) break;
    pool.emplace_back([&fn, a, b] { fn(a, b); });
  }
  fn(static_cast<int64_t>(0), chunk < n ? chunk : n);
  for (auto &th : pool) th.join();
}

template <typename S, typename D>
void convert_loop(const S *src, D *dst, int64_t a, int64_t b) {
  for (int64_t i = a; i < b; ++i) dst[i] = static_cast<D>(src[i]);
}

template <typename S, typename D>
int convert_to(const S *src, void *dst, int64_t n) {
  parallel_for(n, sizeof(S) + sizeof(D), [&](int64_t a, int64_t b) {
    convert_loop(src, static_cast<D *>(dst), a, b);
  });
  return 0;
}

template <typename S>
int convert_from(const S *src, void *dst, int dst_dtype, int64_t n) {
  switch (dst_dtype) {
    case TFR_F32: return convert_to<S, float>(src, dst, n);
    case TFR_F64: return convert_to<S, double>(src, dst, n);
    case TFR_I32: return convert_to<S, int32_t>(src, dst, n);
    case TFR_I64: return convert_to<S, int64_t>(src, dst, n);
    case TFR_U8: return convert_to<S, uint8_t>(src, dst, n);
    default: return -1;
  }
}

/* ---- buffer pool ---------------------------------------------------- */

constexpr int64_t kAlign = 64;
constexpr int64_t kPoolCap = int64_t(1) << 30; /* keep at most 1 GiB */

struct Pool {
  std::mutex mu;
  std::map<int64_t, std::vector<void *>> free_by_size; /* class -> ptrs */
  int64_t cached_bytes = 0;
};

Pool &pool() {
  static Pool *p = new Pool();
  return *p;
}

int64_t size_class(int64_t nbytes) {
  /* the next power of two, at least 256 bytes, so freelists stay few */
  int64_t c = 256;
  while (c < nbytes) c <<= 1;
  return c;
}

} /* namespace */

extern "C" {

const char *tfr_version(void) { return "tfruntime 0.1.0 (host_runtime)"; }

/* Threads of the convert/gather/pack loops; n <= 0 resets to the
 * hardware default. */
void tfr_set_threads(int n) { g_threads.store(n, std::memory_order_relaxed); }

int tfr_get_threads(void) {
  int t = g_threads.load(std::memory_order_relaxed);
  return t > 0 ? t : hw_threads();
}

/* dst[i] = (dst type) src[i] for i < n. 0, or -1 on an unknown dtype. */
int tfr_convert(const void *src, int src_dtype, void *dst, int dst_dtype,
                int64_t n) {
  if (n < 0 || !src || !dst) return -1;
  switch (src_dtype) {
    case TFR_F32: return convert_from(static_cast<const float *>(src), dst, dst_dtype, n);
    case TFR_F64: return convert_from(static_cast<const double *>(src), dst, dst_dtype, n);
    case TFR_I32: return convert_from(static_cast<const int32_t *>(src), dst, dst_dtype, n);
    case TFR_I64: return convert_from(static_cast<const int64_t *>(src), dst, dst_dtype, n);
    case TFR_U8: return convert_from(static_cast<const uint8_t *>(src), dst, dst_dtype, n);
    default: return -1;
  }
}

/* dst[i] = src[idx[i]], rows of row_bytes bytes; idx in [0, n_src).
 * 0, or -1 on a bad index. */
int tfr_gather_rows(const void *src, int64_t n_src, const int64_t *idx,
                    int64_t n_idx, int64_t row_bytes, void *dst) {
  if (!src || !idx || !dst || row_bytes <= 0 || n_idx < 0) return -1;
  const char *s = static_cast<const char *>(src);
  char *d = static_cast<char *>(dst);
  std::atomic<int> bad{0};
  parallel_for(n_idx, row_bytes, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      int64_t j = idx[i];
      if (j < 0 || j >= n_src) {
        bad.store(1, std::memory_order_relaxed);
        return;
      }
      std::memcpy(d + i * row_bytes, s + j * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  });
  return bad.load() ? -1 : 0;
}

/* Concatenate n buffers (ptrs[i], nbytes[i]) into dst; offsets[0..n] gets
 * the CSR byte offsets. dst may be NULL to compute only the offsets.
 * Returns the total bytes. */
int64_t tfr_pack_ragged(const void *const *ptrs, const int64_t *nbytes,
                        int64_t n, void *dst, int64_t *offsets) {
  if (!nbytes || n < 0) return -1;
  std::vector<int64_t> offs(static_cast<size_t>(n) + 1);
  for (int64_t i = 0; i < n; ++i) offs[i + 1] = offs[i] + nbytes[i];
  int64_t total = offs[static_cast<size_t>(n)];
  if (offsets) std::memcpy(offsets, offs.data(), (n + 1) * sizeof(int64_t));
  if (dst && ptrs) {
    /* offsets are known up front, so the row copies are independent */
    char *d = static_cast<char *>(dst);
    int64_t avg = n ? total / n : 0;
    parallel_for(n, avg ? avg : 1, [&](int64_t a, int64_t b) {
      for (int64_t i = a; i < b; ++i)
        std::memcpy(d + offs[static_cast<size_t>(i)], ptrs[i],
                    static_cast<size_t>(nbytes[i]));
    });
  }
  return total;
}

/* Row i holds lens[i] elements of es bytes; dst is [n, max_len] elements,
 * zero padded; mask (may be NULL) is [n, max_len] bytes, 1 = valid.
 * 0, or -1 if some lens[i] exceeds max_len. */
int tfr_pad_ragged(const void *const *ptrs, const int64_t *lens, int64_t n,
                   int64_t max_len, int64_t es, void *dst, uint8_t *mask) {
  if (!ptrs || !lens || !dst || n < 0 || max_len < 0 || es <= 0) return -1;
  for (int64_t i = 0; i < n; ++i)
    if (lens[i] > max_len || lens[i] < 0) return -1;
  char *d = static_cast<char *>(dst);
  parallel_for(n, max_len * es, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      int64_t len = lens[i];
      char *row = d + i * max_len * es;
      std::memcpy(row, ptrs[i], static_cast<size_t>(len * es));
      std::memset(row + len * es, 0,
                  static_cast<size_t>((max_len - len) * es));
      if (mask) {
        uint8_t *mrow = mask + i * max_len;
        std::memset(mrow, 1, static_cast<size_t>(len));
        std::memset(mrow + len, 0, static_cast<size_t>(max_len - len));
      }
    }
  });
  return 0;
}

/* A 64-byte-aligned buffer, reused from the per-size-class freelists when
 * one of its class was freed. */
void *tfr_alloc(int64_t nbytes) {
  if (nbytes <= 0) nbytes = 1;
  int64_t cls = size_class(nbytes);
  Pool &p = pool();
  {
    std::lock_guard<std::mutex> lk(p.mu);
    auto it = p.free_by_size.find(cls);
    if (it != p.free_by_size.end() && !it->second.empty()) {
      void *ptr = it->second.back();
      it->second.pop_back();
      p.cached_bytes -= cls;
      return ptr;
    }
  }
  return ::operator new(static_cast<size_t>(cls), std::align_val_t(kAlign),
                        std::nothrow);
}

void tfr_free(void *ptr, int64_t nbytes) {
  if (!ptr) return;
  int64_t cls = size_class(nbytes <= 0 ? 1 : nbytes);
  Pool &p = pool();
  {
    std::lock_guard<std::mutex> lk(p.mu);
    if (p.cached_bytes + cls <= kPoolCap) {
      p.free_by_size[cls].push_back(ptr);
      p.cached_bytes += cls;
      return;
    }
  }
  ::operator delete(ptr, std::align_val_t(kAlign));
}

/* Bytes cached in the freelists. */
int64_t tfr_pool_bytes(void) {
  Pool &p = pool();
  std::lock_guard<std::mutex> lk(p.mu);
  return p.cached_bytes;
}

/* Release every cached buffer to the system. */
void tfr_pool_trim(void) {
  Pool &p = pool();
  std::lock_guard<std::mutex> lk(p.mu);
  for (auto &kv : p.free_by_size)
    for (void *ptr : kv.second) ::operator delete(ptr, std::align_val_t(kAlign));
  p.free_by_size.clear();
  p.cached_bytes = 0;
}

} /* extern "C" */
