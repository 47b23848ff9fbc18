// Reflect padding of an NHWC activation, with an optional ReLU and an
// optional nearest x2 upsample read through, for Hopper (sm_90a).
//
// fnst_reflect_pad writes y = pad_reflect(up(relu(x))): x an (N, H, W, C)
// NHWC tensor (PyTorch's channels_last), bf16 or f32; relu, if asked,
// max(0, v) with torch.relu's edge cases on the card (-0 becomes +0, NaN
// passes); up,
// if asked, PyTorch's nearest x2 upsample (source index = output index / 2);
// pad_reflect PyTorch's reflect padding by `pad` on each side of H and W
// (the border mirrored about the edge pixel, which is not repeated). y is
// (N, Hu + 2 pad, Wu + 2 pad, C) NHWC, Hu = H * up, Wu = W * up. Every
// value of y is a value of x, or +0 where the ReLU cuts, so y equals
// F.pad(F.interpolate(torch.relu(x), scale_factor=2), mode="reflect") bit
// for bit. It stages the input of every reflect-padded conv of the port's
// stylizers (ops/conv.py::reflect_pad_hw): the AdaIN decoder hands it its
// convs' pre-ReLU outputs, with the ReLU and the upsample before each conv
// folded in.
//
// Replaces no TPU kernel: the JAX package pads with jnp.pad, which XLA
// lowers and fuses by itself. It was added because PyTorch's CUDA
// reflection pad works in NCHW: on a channels_last tensor it costs a
// strided transpose to NCHW, the pad and a strided transpose back, three
// full passes at a small share of the card's bandwidth, and the ReLU and
// the upsample before it two more.
//
// Bound: bytes. There is no arithmetic to speak of, so the least time is
// (read x once + write y once) over the 3.35 TB/s of HBM. With the
// upsample each source row is needed by two output rows; the second read
// comes from L2, so x still crosses HBM about once.
//
// Layout and design. Every output pixel is the C contiguous values of one
// source pixel, and an output row (n, oy) is one contiguous run of
// Wo * C values whose source is one input row (n, sy). A block owns a
// segment of one output row: blockIdx.x is the row, blockIdx.y the
// segment. The row is moved in words of `vec` bytes (16 where the shapes
// allow, else 8, 4 or 2), and thread t of the block's 256 takes words t,
// t + 256, t + 512 and t + 768 of its segment: each warp stores 512
// contiguous bytes at a time, so the stores are fully coalesced, and a
// thread has four loads in flight before its first store. The loads are
// coalesced too, since neighbouring output pixels come from neighbouring
// source pixels, but at the 2 * pad mirrored border pixels of a row,
// which run backwards (still within a few cache lines). Rows next to each
// other are next to each other in the grid, so the two output rows of an
// upsampled source row run at about the same time and the second finds it
// in L2. No shared memory; no division in the element loop.
//
// Two routes, picked by the wrapper (ops/cuda_pad.py::plan_pad):
//   pixel:  C * itemsize is a multiple of the word (and x aligned to it),
//           so every word lies inside one source pixel: one load, one
//           store. Every site of the port's stylizers but the RGB ones.
//   gather: the words of the output row straddle pixels (3-channel RGB,
//           6 or 12 bytes a pixel). A thread assembles its 16-byte word
//           from 8 (bf16) or 4 (f32) element loads of the source pixels
//           it covers, walking (pixel, channel) by increments, and stores
//           it whole; the element loads of a warp fall in a few cache
//           lines, so HBM sees whole lines. The word is 16 bytes where
//           the output row's bytes allow it, else the largest power of two
//           that divides them.
// The grid is N * Ho rows times ceil(row words / 1024) segments, split
// evenly: several waves of the card's 132 SMs at every site shape of the
// port's 256^2 and 512^2 serving paths at B = 8 (5,200 blocks at the
// 128^2 x 256 site, 12,480 at the 512^2 x 32 one).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;   // threads of a block
constexpr int kWordsPerThread = 4;  // words a thread holds in flight
constexpr int kSegWords = kThreads * kWordsPerThread;  // most words a block moves

template <int B>
struct Word;
template <>
struct Word<16> { using T = uint4; };
template <>
struct Word<8> { using T = uint2; };
template <>
struct Word<4> { using T = uint32_t; };
template <>
struct Word<2> { using T = uint16_t; };

struct Geo {
  int h, w, c;       // input rows, columns, channels
  int ho;            // output rows
  int hu, wu;        // rows and columns after the upsample
  int pad;           // reflect padding on each side
  int up_shift;      // 1 with the x2 upsample, else 0
  int row_words;     // words of an output row
  int seg_words;     // words of a block's segment (<= kSegWords)
};

// The source index along one axis: output index o, padded by `pad` about an
// axis of n (upsampled) entries, mirrored at both ends without repeating
// the edge, then halved where the axis was upsampled.
__device__ __forceinline__ int src_index(int o, int pad, int n, int up_shift) {
  int t = o - pad;
  t = t < 0 ? -t : (t >= n ? 2 * (n - 1) - t : t);
  return t >> up_shift;
}

// max(0, v) on the bits of one element (E: uint16_t for bf16, uint32_t for
// f32): a number with the sign bit set that is not NaN (-0 included) becomes
// +0, as torch.relu on the card.
template <typename E>
__device__ __forceinline__ E relu_bits(E v) {
  constexpr uint32_t kSign = 1u << (8 * sizeof(E) - 1);
  constexpr uint32_t kInf = sizeof(E) == 2 ? 0x7F80u : 0x7F800000u;
  const uint32_t u = v;
  return ((u & kSign) && (u & (kSign - 1)) <= kInf) ? E(0) : v;
}

template <typename E, int B>
__device__ __forceinline__ typename Word<B>::T relu_word(typename Word<B>::T w) {
  E e[B / sizeof(E)];
  memcpy(e, &w, B);
#pragma unroll
  for (int i = 0; i < B / int(sizeof(E)); ++i) e[i] = relu_bits(e[i]);
  memcpy(&w, e, B);
  return w;
}

// pixel route: word j of the output row lies in output pixel j / ppx.
template <typename E, int B, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    pad_pixels(const typename Word<B>::T* __restrict__ x,
               typename Word<B>::T* __restrict__ y, Geo g) {
  using W = typename Word<B>::T;
  const int row = blockIdx.x;
  const int n = row / g.ho;
  const int oy = row - n * g.ho;
  const int sy = src_index(oy, g.pad, g.hu, g.up_shift);
  const int ppx = g.c * int(sizeof(E)) / B;  // words a pixel
  const W* src = x + ((long long)n * g.h + sy) * g.w * ppx;
  W* dst = y + (long long)row * g.row_words;
  const int begin = blockIdx.y * g.seg_words;
  const int end = min(begin + g.seg_words, g.row_words);
  W v[kWordsPerThread];
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int j = begin + u * kThreads + threadIdx.x;
    if (j < end) {
      const int ox = j / ppx;
      const int k = j - ox * ppx;
      v[u] = __ldg(src + src_index(ox, g.pad, g.wu, g.up_shift) * ppx + k);
    }
  }
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int j = begin + u * kThreads + threadIdx.x;
    if (j < end) dst[j] = kRelu ? relu_word<E, B>(v[u]) : v[u];
  }
}

// gather route: word j of the output row holds elements j * kElems ..
// (j + 1) * kElems - 1 of the row, which may span source pixels.
template <typename E, int B, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    pad_gather(const E* __restrict__ x, typename Word<B>::T* __restrict__ y,
               Geo g) {
  using W = typename Word<B>::T;
  constexpr int kElems = B / int(sizeof(E));
  const int row = blockIdx.x;
  const int n = row / g.ho;
  const int oy = row - n * g.ho;
  const int sy = src_index(oy, g.pad, g.hu, g.up_shift);
  const E* src = x + ((long long)n * g.h + sy) * g.w * g.c;
  W* dst = y + (long long)row * g.row_words;
  const int begin = blockIdx.y * g.seg_words;
  const int end = min(begin + g.seg_words, g.row_words);
  W v[kWordsPerThread];
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int j = begin + u * kThreads + threadIdx.x;
    if (j < end) {
      const int e0 = j * kElems;
      int ox = e0 / g.c;
      int ch = e0 - ox * g.c;
      const E* pix = src + src_index(ox, g.pad, g.wu, g.up_shift) * g.c;
      E e[kElems];
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const E a = __ldg(pix + ch);
        e[i] = kRelu ? relu_bits(a) : a;
        if (++ch == g.c && i + 1 < kElems) {
          ch = 0;
          ++ox;
          pix = src + src_index(ox, g.pad, g.wu, g.up_shift) * g.c;
        }
      }
      memcpy(&v[u], e, B);
    }
  }
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int j = begin + u * kThreads + threadIdx.x;
    if (j < end) dst[j] = v[u];
  }
}

template <typename E, int B>
cudaError_t launch_b(const void* x, void* y, const Geo& g, int rows, int segs,
                     bool relu, bool gather, cudaStream_t st) {
  using W = typename Word<B>::T;
  const dim3 grid(rows, segs);
  const W* xw = static_cast<const W*>(x);
  const E* xe = static_cast<const E*>(x);
  W* yw = static_cast<W*>(y);
  if (gather) {
    if (relu) {
      pad_gather<E, B, true><<<grid, kThreads, 0, st>>>(xe, yw, g);
    } else {
      pad_gather<E, B, false><<<grid, kThreads, 0, st>>>(xe, yw, g);
    }
  } else if (relu) {
    pad_pixels<E, B, true><<<grid, kThreads, 0, st>>>(xw, yw, g);
  } else {
    pad_pixels<E, B, false><<<grid, kThreads, 0, st>>>(xw, yw, g);
  }
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_e(const void* x, void* y, const Geo& g, int rows, int segs,
                     int vec, bool relu, bool gather, cudaStream_t st) {
  switch (vec) {
    case 16: return launch_b<E, 16>(x, y, g, rows, segs, relu, gather, st);
    case 8: return launch_b<E, 8>(x, y, g, rows, segs, relu, gather, st);
    case 4: return launch_b<E, 4>(x, y, g, rows, segs, relu, gather, st);
    default: break;
  }
  if constexpr (sizeof(E) == 2) {
    if (vec == 2) return launch_b<E, 2>(x, y, g, rows, segs, relu, gather, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (n, h, w, c) NHWC, bf16 (is_bf16) or f32; y: (n, h * up + 2 pad,
// w * up + 2 pad, c) NHWC out, x's dtype, 16-byte aligned. up 1 or 2;
// 0 <= pad < h * up and w * up. vec: the word in bytes (16, 8, 4 or 2, at
// least the element); gather 0: the pixel route (c * itemsize a multiple of
// vec, x aligned to vec), 1: the gather route (the output row's bytes a
// multiple of vec). seg_words words a block (<= 1024), segs blocks a row,
// segs * seg_words >= the row's words. Launches on ``stream``; returns the
// CUDA error code (0 on success). Allocates nothing.
extern "C" int fnst_reflect_pad(const void* x, void* y, int n, int c, int h,
                                int w, int pad, int up, int relu, int is_bf16,
                                int vec, int gather, int seg_words, int segs,
                                void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (n < 1 || c < 1 || h < 1 || w < 1 || (up != 1 && up != 2) || pad < 0 ||
      pad >= h * up || pad >= w * up || vec < esize || vec > 16 ||
      (vec & (vec - 1)) != 0 || seg_words < 1 || seg_words > kSegWords ||
      segs < 1 || (reinterpret_cast<uintptr_t>(y) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  Geo g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.hu = h * up;
  g.wu = w * up;
  g.ho = g.hu + 2 * pad;
  g.pad = pad;
  g.up_shift = up == 2 ? 1 : 0;
  const long long row_bytes = (long long)(g.wu + 2 * pad) * c * esize;
  if (row_bytes % vec != 0 || row_bytes / vec > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (!gather && ((c * esize) % vec != 0 ||
                  (reinterpret_cast<uintptr_t>(x) % vec) != 0)) {
    return cudaErrorInvalidValue;
  }
  g.row_words = static_cast<int>(row_bytes / vec);
  g.seg_words = seg_words;
  if ((long long)segs * seg_words < g.row_words || segs > 65535) {
    return cudaErrorInvalidValue;
  }
  const long long rows = (long long)n * g.ho;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_e<uint16_t>(x, y, g, static_cast<int>(rows), segs, vec,
                                      relu != 0, gather != 0, st)
                 : launch_e<uint32_t>(x, y, g, static_cast<int>(rows), segs, vec,
                                      relu != 0, gather != 0, st);
}
