// Source note: the port's copy of tf_operator_tpu/native/augment.cc, the JAX
// package's host C++, unchanged below this note and with the same C ABI.
// It is host code, not a TPU kernel, so it has no CUDA counterpart: the
// port builds it with g++ (native/__init__.py::load_library) into
// native/_build/ and binds it with ctypes (native/augment.py).
//
// Host-side image augmentation: random/center crop + horizontal flip over
// uint8 batches, threaded off the GIL.
//
// The preprocessing half of the native input path (record_pipeline.cc does
// IO; this does the per-image work between records and the device): TPU
// training keeps images uint8 end-to-end on the host and normalizes on
// device, so the host cost is pure byte movement — which is exactly what a
// C++ loop with threads does well and a Python per-image loop does not.
//
// Determinism contract (shared with the Python fallback in
// native/augment.py and with record_pipeline's shuffle): per-image
// decisions derive from splitmix64(seed * 1000003 + global_index), so
// native and Python engines produce BIT-IDENTICAL output for the same
// (seed, index) stream and tests can assert equivalence.
//
// C ABI:
//   aug_batch(in, out, n, in_h, in_w, ch, out_h, out_w, seed, index0,
//             train, threads, in_stride) -> 0 ok, <0 bad args
//   in_stride: bytes between consecutive source images (0 => contiguous,
//   i.e. in_h*in_w*ch); lets the crop consume raw record buffers directly.
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64_next(uint64_t* s) {
  *s += 0x9E3779B97F4A7C15ull;
  uint64_t z = *s;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Args {
  const uint8_t* in;
  uint8_t* out;
  uint64_t in_h, in_w, ch, out_h, out_w, seed, index0;
  // Byte distance between consecutive source images: lets the crop read
  // straight out of a raw RECORDS buffer (image bytes + trailing label
  // byte per record) with no intermediate slice-and-reshape copy of the
  // whole batch on the Python side.
  uint64_t in_stride;
  int train;
};

// Domain separator: keeps augment decision streams disjoint from the
// record-pipeline shuffle streams (epoch_order keys seed*1000003+epoch in
// the same splitmix64 keyspace) even when a user passes one seed to both.
constexpr uint64_t kAugmentDomain = 0x6175676D656E7400ull;  // "augment\0"

void one_image(const Args& a, uint64_t i) {
  uint64_t s = ((a.seed * 1000003ull + a.index0 + i) ^ kAugmentDomain) ^
               0x9E3779B97F4A7C15ull;
  uint64_t max_y = a.in_h - a.out_h, max_x = a.in_w - a.out_w;
  uint64_t y, x;
  bool flip;
  if (a.train) {
    y = max_y ? splitmix64_next(&s) % (max_y + 1) : 0;
    x = max_x ? splitmix64_next(&s) % (max_x + 1) : 0;
    flip = splitmix64_next(&s) & 1;
  } else {  // eval: deterministic center crop, no flip
    y = max_y / 2;
    x = max_x / 2;
    flip = false;
  }
  const uint8_t* src = a.in + i * a.in_stride;
  uint8_t* dst = a.out + i * a.out_h * a.out_w * a.ch;
  for (uint64_t r = 0; r < a.out_h; ++r) {
    const uint8_t* row = src + ((y + r) * a.in_w + x) * a.ch;
    uint8_t* drow = dst + r * a.out_w * a.ch;
    if (!flip) {
      std::memcpy(drow, row, a.out_w * a.ch);
    } else if (a.ch == 3) {
      // RGB fast path: a runtime-sized memcpy(.., .., 3) per pixel is a
      // real function call the compiler cannot inline — it dominated the
      // whole augment stage (~50% of train images flip). Constant-size
      // copies compile to plain byte moves.
      for (uint64_t c = 0; c < a.out_w; ++c) {
        const uint8_t* s3 = row + (a.out_w - 1 - c) * 3;
        uint8_t* d3 = drow + c * 3;
        d3[0] = s3[0];
        d3[1] = s3[1];
        d3[2] = s3[2];
      }
    } else {
      for (uint64_t c = 0; c < a.out_w; ++c) {
        std::memcpy(drow + c * a.ch, row + (a.out_w - 1 - c) * a.ch, a.ch);
      }
    }
  }
}

}  // namespace

// Gather form: image i comes from base + indices[i] * record_stride — the
// zero-copy host path for page-cache-resident record files. With an
// mmap'd file the ONLY host byte movement per image is the crop write
// itself; there is no loader read, no batch assembly, no glue copy. On a
// single-core host this roughly doubles input throughput over the
// pread-ring + strided-augment path (~3.3k -> ~7k img/s at 256^2 -> 224^2
// bench shapes).
extern "C" int aug_gather(const uint8_t* base, const uint64_t* indices,
                          uint8_t* out, uint64_t n, uint64_t record_stride,
                          uint64_t in_h, uint64_t in_w, uint64_t ch,
                          uint64_t out_h, uint64_t out_w, uint64_t seed,
                          uint64_t index0, int train, int threads) {
  if (!base || !indices || !out || out_h > in_h || out_w > in_w || ch == 0)
    return -1;
  if (record_stride < in_h * in_w * ch) return -1;
  uint64_t t = threads > 0 ? static_cast<uint64_t>(threads) : 1;
  uint64_t hw = std::thread::hardware_concurrency();
  if (hw && t > hw) t = hw;
  if (t > n) t = n ? n : 1;
  auto run = [&](uint64_t w, uint64_t stride_threads) {
    for (uint64_t i = w; i < n; i += stride_threads) {
      Args a{base + indices[i] * record_stride, out + i * out_h * out_w * ch,
             in_h, in_w, ch, out_h, out_w, seed, index0 + i,
             in_h * in_w * ch, train};
      one_image(a, 0);
    }
  };
  if (t <= 1) {
    run(0, 1);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (uint64_t w = 0; w < t; ++w) pool.emplace_back(run, w, t);
  for (auto& th : pool) th.join();
  return 0;
}

extern "C" int aug_batch(const uint8_t* in, uint8_t* out, uint64_t n,
                         uint64_t in_h, uint64_t in_w, uint64_t ch,
                         uint64_t out_h, uint64_t out_w, uint64_t seed,
                         uint64_t index0, int train, int threads,
                         uint64_t in_stride) {
  if (!in || !out || out_h > in_h || out_w > in_w || ch == 0) return -1;
  if (in_stride == 0) in_stride = in_h * in_w * ch;
  if (in_stride < in_h * in_w * ch) return -1;
  Args a{in, out, in_h, in_w, ch, out_h, out_w, seed, index0, in_stride,
         train};
  uint64_t t = threads > 0 ? static_cast<uint64_t>(threads) : 1;
  // More threads than cores just adds spawn/contention cost for a
  // memory-bound loop (observed on single-core CI hosts).
  uint64_t hw = std::thread::hardware_concurrency();
  if (hw && t > hw) t = hw;
  if (t > n) t = n ? n : 1;
  if (t <= 1) {
    for (uint64_t i = 0; i < n; ++i) one_image(a, i);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (uint64_t w = 0; w < t; ++w) {
    pool.emplace_back([&, w]() {
      for (uint64_t i = w; i < n; i += t) one_image(a, i);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}
