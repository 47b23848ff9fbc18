// Backward of a stride-1, zero-padded SAME convolution with a small input
// channel count, for Hopper (sm_90a). On the training path this is VGG
// conv1_1's input gradient: g (N, 256, 256, 64) in, dx (N, 256, 256, 3) out.
//
// Replaces the TPU kernel fast_neural_style_transfer_tpu/ops/pallas_conv.py::
// _bwd_kernel (launched by conv2d_same_bwd and conv2d_same_dx). With
// p = k / 2 and W[u, v, i, o] = w[o, i, u, v] (PyTorch OIHW):
//   dx[n, h, w, i]  = sum_{u, v, o} g[n, h + p - u, w + p - v, o] W[u, v, i, o]
//                     (g is zero outside the image)
//   dw[u, v, i, o]  = sum_{n, h, w} x[n, h + u - p, w + v - p, i] g[n, h, w, o]
//   db[o]           = sum_{n, h, w} g[n, h, w, o]
// with f32 accumulation. dx is written in g's dtype; dw and db in f32.
//
// Gate (set by these kernels, not by the TPU's tiling): odd k <= 11,
// stride 1, k * k * C_in <= 128, any H and W, any C_out. The wrapper
// (ops/cuda_conv.py) raises outside it.
//
// Layout. g arrives as PyTorch's channels_last (N, C_out, H, W), physically
// NHWC, which is how autograd hands over the ReLU gradient of conv1_1's
// output. dx is written channels_last too (NHWC, 3 values per pixel), the
// layout of the conv input x, so autograd needs no copy on either side. The
// TPU kernel wrote planar NCHW because its shifted adds wanted W on the 128
// lanes; here a warp's 32 threads own 32 neighbouring pixels of one row, so
// an NHWC store of their 3 channels is one contiguous 192-byte (bf16) or
// 384-byte (f32) run: coalesced, with no transpose afterwards.
//
// Two kernels. The wrapper's planner (ops/cuda_conv.py::plan_conv_dx) picks
// the dx-only kernel from the shape alone, before the launch.
//
// 1. conv_dx_tap_packed (route "tap_packed", dx only: VGG conv1_1 on the
//    training path). Gate: C_out = 64, k >= 3, k * k * C_in <= 32 (k, C_in
//    = 3, 1..3 or 5, 1: both template parameters, so every index folds), g
//    16-byte aligned, w in g's dtype. The TPU kernel's tap-packed form:
//      P[q, (u, v, i)] = sum_o g[q, o] w[o, i, u, v]        (per pixel q)
//      dx[h, w, i]     = sum_{u, v} P[(h + p - u, w + p - v), (u, v, i)]
//    A block owns a strip of 64 output columns and walks down a run of
//    rows (the TPU's sequential grid, moved inside the block). Per row:
//    - g's row segment (64 + 2p columns x 64 channels) arrives in a ring of
//      4 stages through 16-byte cp.async (zero-filled outside the image:
//      src-size 0), so g crosses HBM once, plus the 2p-row halo of a run;
//    - P for the segment = (66 pixels x 64) . (64 x 27 -> 32) on the tensor
//      cores, one warp per m-tile of 16 pixels, W' read once a block; P
//      goes to a ring of k rows in shared memory in f32 (rounding P to
//      bf16 would break the tolerance);
//    - once P rows r - p .. r + p are in the ring, dx row r: one thread a
//      pixel, k * k P reads per output value in a fixed order, staged in
//      shared memory (two segments, alternating) and stored in 16-byte
//      packs after the next row's first barrier (the segment's 64 x 3
//      values are one NHWC run). Two barriers a row.
//    bf16: mma.sync m16n8k16 with f32 accumulators; A by ldmatrix from a
//    g stage stored with its 16-byte chunks XOR-swizzled by pixel (a pixel
//    is 128 B, so unswizzled rows fall on the same banks); B = 4 k-steps x
//    4 n-tiles x 2 = 32 registers. bf16 products are exact in f32, so only
//    the order of the sums differs from the plain version.
//    f32: split TF32 (3xTF32's terms in two products). Each operand is
//    split into a TF32 high part and its f32 remainder: g = hi + lo, W' =
//    Hi + Lo. hi . Hi runs on mma.sync m16n8k8 (TF32); the cross terms lo .
//    Hi + hi . Lo run as one bf16 m16n8k16 product whose 16 k slots hold
//    the 8 channels of a TF32 k-step twice ([lo | hi] against [Hi ; Lo]).
//    TF32 alone errs by 2^-11 an operand, above the 1e-4 tolerance of the
//    f32 checks; here the cross terms (2^-11 of a product) are rounded to
//    bf16 (2^-9 of them) and lo . Lo is dropped: ~2^-19 of a product. Two
//    tensor-core products a k-step, not 3xTF32's three: the f32 product is
//    what the kernel's time above its loads goes to. Chosen over
//    register-blocked FFMA because 1,728 FFMA a pixel would need 65 % of the
//    f32 peak to meet the bytes bound. W' lives in shared memory as
//    fragment packs (16 KB), which keeps the kernel at ~130 registers.
//    Bound: bytes. g once and dx once: at B=20, 256x256, 167.8 + 7.9 MB in
//    bf16, 335.5 + 15.7 MB in f32: 0.052 / 0.105 ms over 3.35 TB/s; the
//    products (1,728 MACs a useful pixel) take ~0.01 ms of the bf16 tensor
//    rate and ~0.03 ms of the TF32 and bf16 rates at two products each.
//    Waves. The blocks do not depend on each other, so the grid is one
//    wave: blocks = SMs x blocks an SM holds (4 in bf16 at ~55 KB of shared
//    memory, 2 in f32 at ~104 KB; asked of the card). The n x strips x H
//    row segments are cut into equal contiguous ranges, one a block; a
//    range that crosses a strip's last row goes on at the next strip's
//    first (a new piece, with its own 2p halo rows). At B=20, 256x256:
//    20 x 4 x 256 = 20,480 rows over 528 blocks (bf16), 38.8 rows each, or
//    264 blocks (f32), 77.6 each; every block gets the same work to one
//    row, so no wave runs nearly empty. The halo costs 2p rows a piece,
//    ~1.15 / ~1.3 pieces a block: ~6 % / ~3.4 % more P and g rows, the
//    extra g rows mostly from L2 (the neighbouring block reads them too).
//    No atomics and fixed orders: repeated calls agree bit for bit.
//
// 2. conv_same_bwd_kernel (route "tiled"; and full mode, dx + dw + db, for
//    every shape in the gate). One block of 8 x 32 threads owns an 8 x 32
//    tile of output pixels, one pixel a thread. For each group of 4 input
//    channels and each chunk of 32 output channels it stages in shared
//    memory:
//      gs: the chunk of g over the tile plus a p-pixel halo, converted to
//          f32 and stored [row][channel][column], with an odd column
//          stride, so the warp's 32 columns fall on 32 banks;
//      ws: the chunk's weights [o][u * k + v][i], read as float4 broadcasts.
//    Each thread then accumulates its 4 dx values over k * k * 32 products.
//    Each block stages its own halo (the re-read halo rows come from L2).
//    Its scalar staging and the zero-padded fourth input channel keep it
//    bound by instructions (PERF.md, Findings).
//    Full mode (dw and db as well) runs a persistent grid of at most
//    4 * 132 blocks over the tiles. Each block also stages its tile of x
//    with the halo, and each thread owns some (u, v, i, o) entries of dw
//    (and db), summing x * g over the tile's pixels into the block's row of
//    an f32 workspace (zeroed by the wrapper). A second short launch adds
//    the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;    // output rows per tile
constexpr int kTW = 32;   // output columns per tile: one warp per row
constexpr int kOC = 32;   // output channels of g staged per pass
constexpr int kThreads = kTH * kTW;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Geometry shared by the host and the kernel.
struct Geo {
  int n, h, w, ci, co, ci4, tiles_h, tiles_w;
};

__host__ __device__ constexpr int halo_rows(int k) { return kTH + 2 * (k / 2); }
__host__ __device__ constexpr int halo_cols(int k) { return kTW + 2 * (k / 2); }
// odd column stride: 32 consecutive columns, or 32 channels one row apart,
// land on 32 distinct banks
__host__ __device__ constexpr int col_stride(int k) { return halo_cols(k) | 1; }

template <typename T, bool kFull, int K>
__global__ void __launch_bounds__(kThreads)
    conv_same_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                         const float* __restrict__ wpk, T* __restrict__ dx,
                         float* __restrict__ work, Geo geo) {
  constexpr int P = K / 2;
  constexpr int KK = K * K;
  constexpr int RH = halo_rows(K);
  constexpr int CW = halo_cols(K);
  constexpr int GS = col_stride(K);

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);          // [kOC][KK][ci4]
  float* gs = ws + kOC * KK * geo.ci4;                  // [RH][kOC][GS]
  float* xs = gs + RH * kOC * GS;                       // [RH][ci][GS]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int ngroups = geo.ci4 / 4;
  const int tiles = geo.n * geo.tiles_h * geo.tiles_w;
  const int entries = (KK * geo.ci + 1) * geo.co;  // dw then db, per block row

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nb = tile / (geo.tiles_h * geo.tiles_w);
    const int rem = tile - nb * geo.tiles_h * geo.tiles_w;
    const int h0 = (rem / geo.tiles_w) * kTH;
    const int w0 = (rem % geo.tiles_w) * kTW;
    const int oh = h0 + ty;
    const int ow = w0 + tx;

    __syncthreads();  // the previous tile is done with xs
    if (kFull) {
      for (int idx = tid; idx < RH * CW * geo.ci; idx += kThreads) {
        const int i = idx % geo.ci;
        const int pix = idx / geo.ci;
        const int col = pix % CW;
        const int row = pix / CW;
        const int gh = h0 - P + row;
        const int gw = w0 - P + col;
        float v = 0.f;
        if (gh >= 0 && gh < geo.h && gw >= 0 && gw < geo.w) {
          v = to_f32(x[(((size_t)nb * geo.h + gh) * geo.w + gw) * geo.ci + i]);
        }
        xs[(row * geo.ci + i) * GS + col] = v;
      }
    }

    for (int grp = 0; grp < ngroups; ++grp) {
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
      for (int o0 = 0; o0 < geo.co; o0 += kOC) {
        const int occ = min(kOC, geo.co - o0);
        __syncthreads();  // everyone is done with the previous chunk
        for (int idx = tid; idx < RH * CW * occ; idx += kThreads) {
          const int oc = idx % occ;
          const int pix = idx / occ;
          const int col = pix % CW;
          const int row = pix / CW;
          const int gh = h0 - P + row;
          const int gw = w0 - P + col;
          float v = 0.f;
          if (gh >= 0 && gh < geo.h && gw >= 0 && gw < geo.w) {
            v = to_f32(
                g[(((size_t)nb * geo.h + gh) * geo.w + gw) * geo.co + o0 + oc]);
          }
          gs[(row * kOC + oc) * GS + col] = v;
        }
        const float* wsrc = wpk + (size_t)o0 * KK * geo.ci4;
        for (int idx = tid; idx < occ * KK * geo.ci4; idx += kThreads) {
          ws[idx] = wsrc[idx];
        }
        __syncthreads();

        // dx: this thread's pixel, input channels 4 * grp .. 4 * grp + 3
        const float4* w4 = reinterpret_cast<const float4*>(ws) + grp;
        const int q = geo.ci4 / 4;  // float4s per (o, u, v)
        for (int oc = 0; oc < occ; ++oc) {
          const float* grow = gs + oc * GS + tx + 2 * P;
#pragma unroll
          for (int u = 0; u < K; ++u) {
            const float* gr = grow + (ty + 2 * P - u) * kOC * GS;
#pragma unroll
            for (int v = 0; v < K; ++v) {
              const float gv = gr[-v];
              const float4 wv = w4[(oc * KK + u * K + v) * q];
              acc0 += gv * wv.x;
              acc1 += gv * wv.y;
              acc2 += gv * wv.z;
              acc3 += gv * wv.w;
            }
          }
        }

        if (kFull && grp == 0) {
          // dw / db entries of this chunk: e -> (r, oc), r < KK * ci is the
          // tap (u, v, i), r == KK * ci is the bias
          const int rows = KK * geo.ci + 1;
          float* wrow = work + (size_t)blockIdx.x * entries;
          for (int e = tid; e < rows * occ; e += kThreads) {
            const int oc = e % occ;
            const int r = e / occ;
            const float* gp = gs + (P * kOC + oc) * GS + P;
            float s = 0.f;
            if (r < KK * geo.ci) {
              const int uv = r / geo.ci;
              const int i = r - uv * geo.ci;
              const int u = uv / K;
              const int v = uv - u * K;
              const float* xp = xs + (u * geo.ci + i) * GS + v;
              for (int yy = 0; yy < kTH; ++yy) {
                const float* xr = xp + yy * geo.ci * GS;
                const float* gr = gp + yy * kOC * GS;
#pragma unroll 8
                for (int xx = 0; xx < kTW; ++xx) s += xr[xx] * gr[xx];
              }
            } else {
              for (int yy = 0; yy < kTH; ++yy) {
                const float* gr = gp + yy * kOC * GS;
#pragma unroll 8
                for (int xx = 0; xx < kTW; ++xx) s += gr[xx];
              }
            }
            wrow[(size_t)r * geo.co + o0 + oc] += s;
          }
        }
      }
      if (oh < geo.h && ow < geo.w) {
        T* out = dx + (((size_t)nb * geo.h + oh) * geo.w + ow) * geo.ci;
        const int i0 = 4 * grp;
        if (i0 < geo.ci) out[i0] = from_f32<T>(acc0);
        if (i0 + 1 < geo.ci) out[i0 + 1] = from_f32<T>(acc1);
        if (i0 + 2 < geo.ci) out[i0 + 2] = from_f32<T>(acc2);
        if (i0 + 3 < geo.ci) out[i0 + 3] = from_f32<T>(acc3);
      }
    }
  }
}

// out[j] = sum_b work[b, j]: the per-block dw / db rows, added in order.
__global__ void __launch_bounds__(256)
    reduce_rows(const float* __restrict__ work, float* __restrict__ out,
                int rows, int entries) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= entries) return;
  float s = 0.f;
  for (int b = 0; b < rows; ++b) s += work[(size_t)b * entries + j];
  out[j] = s;
}

size_t smem_bytes(int k, int ci4, int ci, bool full) {
  size_t floats = (size_t)kOC * k * k * ci4 + (size_t)halo_rows(k) * kOC * col_stride(k);
  if (full) floats += (size_t)halo_rows(k) * ci * col_stride(k);
  return floats * sizeof(float);
}

template <typename T, bool kFull, int K>
cudaError_t launch_k(const void* g, const void* x, const float* wpk, void* dx,
                     float* work, float* dwb, const Geo& geo, int blocks,
                     cudaStream_t stream) {
  auto kernel = conv_same_bwd_kernel<T, kFull, K>;
  const size_t smem = smem_bytes(K, geo.ci4, geo.ci, kFull);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, dim3(kTW, kTH), smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), wpk,
      static_cast<T*>(dx), work, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kFull) return err;
  const int entries = (K * K * geo.ci + 1) * geo.co;
  reduce_rows<<<(entries + 255) / 256, 256, 0, stream>>>(work, dwb, blocks,
                                                         entries);
  return cudaGetLastError();
}

template <typename T, bool kFull>
cudaError_t launch_t(int k, const void* g, const void* x, const float* wpk,
                     void* dx, float* work, float* dwb, const Geo& geo,
                     int blocks, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_k<T, kFull, 1>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    case 3: return launch_k<T, kFull, 3>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    case 5: return launch_k<T, kFull, 5>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    case 7: return launch_k<T, kFull, 7>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    case 9: return launch_k<T, kFull, 9>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    case 11: return launch_k<T, kFull, 11>(g, x, wpk, dx, work, dwb, geo, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---- route "tap_packed": conv_dx_tap_packed ---------------------------------

namespace tp {

constexpr int kSW = 64;     // output columns of a strip
constexpr int kStages = 4;  // g rows a block has in flight, less one
constexpr int kCO = 64;     // the C_out this kernel takes

// g columns (and P pixels) of a strip's row, m-tiles of 16 over them, and
// the block: one warp an m-tile
__host__ __device__ constexpr int qcols(int k) { return kSW + 2 * (k / 2); }
__host__ __device__ constexpr int nthreads(int k) { return 32 * ((qcols(k) + 15) / 16); }
// odd stride of a P pixel (floats): a warp's 32 pixels fall on 32 banks
__host__ __device__ constexpr int pstride(int kkc) { return kkc | 1; }
// n-tiles of 8 P columns
__host__ __device__ constexpr int ntiles(int kkc) { return (kkc + 7) / 8; }
// blocks an SM is meant to hold (caps the registers): 4 in bf16, 2 in f32
__host__ __device__ constexpr int min_blocks(int itemsize) { return itemsize == 2 ? 4 : 2; }

// dynamic shared memory: kStages g stages, the ring of k P rows (f32), two
// dx row segments (each with room to shift it onto the 16-byte grid of
// dx) and, in f32, W' as mma fragments
struct Layout {
  int stage;  // bytes of one g stage
  int ring;   // offset of the P ring
  int outs;   // offset of the dx segments
  int seg;    // bytes of one dx segment
  int frags;  // offset of W' (f32)
  int total;
};
__host__ __device__ constexpr Layout layout(int k, int ci, int itemsize) {
  const int stage = qcols(k) * kCO * itemsize;
  const int ring = kStages * stage;
  const int outs = ring + (k * qcols(k) * pstride(k * k * ci) * 4 + 15) / 16 * 16;
  const int seg = (kSW * ci * itemsize + 16 + 15) / 16 * 16;
  const int frags = outs + 2 * seg;
  const int wbytes = itemsize == 4 ? (kCO / 8) * ntiles(k * k * ci) * 32 * 16 : 0;
  return Layout{stage, ring, outs, seg, frags, frags + wbytes};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b: A 16 x 8 tf32 (row), B 8 x 8 tf32 (col), C 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi rounded to TF32, lo the exact f32 remainder (the tensor
// core reads its top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two f32 (as bits) rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_f32x2(uint32_t lo, uint32_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__uint_as_float(lo), __uint_as_float(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// W'[o][j], j = (u * K + v) * CI + i: w[o, i, u, v] (OIHW), 0 past K*K*CI
template <typename T, int K, int CI>
__device__ __forceinline__ T wtap(const T* w, int o, int j) {
  if (j >= K * K * CI) return from_f32<T>(0.f);
  return w[(o * CI + j % CI) * K * K + j / CI];
}

template <typename T, int K, int CI>
__global__ void __launch_bounds__(nthreads(K), min_blocks(sizeof(T)))
    conv_dx_tap_packed(const T* __restrict__ g, const T* __restrict__ w,
                       T* __restrict__ dx, int h, int wd, int strips,
                       long long rows_total) {
  constexpr bool kBF = sizeof(T) == 2;
  constexpr int P = K / 2;
  constexpr int QC = qcols(K);
  constexpr int NTH = nthreads(K);
  constexpr int KKC = K * K * CI;
  constexpr int PS = pstride(KKC);
  constexpr int NT = ntiles(KKC);
  constexpr int KS = kBF ? kCO / 16 : kCO / 8;  // k-steps of the product
  constexpr int PIX = kCO * (int)sizeof(T);     // bytes of a pixel of g
  constexpr int CH = PIX / 16;                  // its 16-byte chunks
  constexpr int V = 16 / (int)sizeof(T);        // values in 16 bytes
  constexpr int NCP = (QC * CH + NTH - 1) / NTH;  // a thread's chunks of a row
  constexpr Layout lay = layout(K, CI, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + lay.ring);  // [K][QC][PS]
  const uint32_t stages = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // the fragments' row group
  const int tig = lane & 3;   // and thread in the group
  const int m0 = (tid >> 5) * 16;  // this warp's m-tile

  // W' (64 x 8 NT) as mma fragments for the block's life. bf16: in
  // registers (KS x NT x 2), b0 holding B[k = 2 tig (+1)][n = gid], b1 the
  // 8 k on. f32: one 16-byte pack per (k-step, n-tile, lane) in shared
  // memory: the TF32 high parts of B[tig][gid] and B[tig + 4][gid], then
  // the bf16 fragment of the cross terms' B (see the product below)
  uint32_t bw[kBF ? KS : 1][NT][2];
  const uint4* wfrag = reinterpret_cast<const uint4*>(smem + lay.frags);
  if constexpr (kBF) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = ks * 16 + 2 * tig + 8 * r;
          bw[ks][nt][r] = pack_bf16(wtap<T, K, CI>(w, o, nt * 8 + gid),
                                    wtap<T, K, CI>(w, o + 1, nt * 8 + gid));
        }
      }
    }
  } else {
    uint4* dst = reinterpret_cast<uint4*>(smem + lay.frags);
    for (int e = tid; e < KS * NT * 32; e += NTH) {
      const int l = e & 31;
      const int nt = (e >> 5) % NT;
      const int ks = (e >> 5) / NT;
      uint32_t h0, l0, h1, l1;
      split_tf32(wtap<T, K, CI>(w, ks * 8 + (l & 3), nt * 8 + (l >> 2)), h0, l0);
      split_tf32(wtap<T, K, CI>(w, ks * 8 + (l & 3) + 4, nt * 8 + (l >> 2)), h1, l1);
      dst[e] = make_uint4(h0, h1, pack_f32x2(h0, h1), pack_f32x2(l0, l1));
    }
  }

  // this thread's 16-byte chunks of a g row: chunk e = tid + j NTH is
  // chunk c of pixel q, stored at chunk c ^ (q & 7) of the pixel
  uint32_t soff[NCP];
  int qof[NCP];
#pragma unroll
  for (int j = 0; j < NCP; ++j) {
    const int e = tid + j * NTH;
    const int q = e / CH;
    const int c = e % CH;
    soff[j] = q * PIX + ((c ^ (q & 7)) << 4);
    qof[j] = e < QC * CH ? q * kCO + c * V : -1;  // -1: no chunk
  }

  // this block's rows: [idx, end) of the n x strips x h row segments
  long long idx = rows_total * blockIdx.x / gridDim.x;
  const long long end = rows_total * (blockIdx.x + 1) / gridDim.x;
  while (idx < end) {
    // one piece: rows [ra, rb) of one strip of one image
    const long long col = idx / h;
    const int ra = static_cast<int>(idx - col * h);
    const int rb = static_cast<int>(min(static_cast<long long>(h), ra + (end - idx)));
    idx += rb - ra;
    const int nb = static_cast<int>(col / strips);
    const int c0 = static_cast<int>(col - static_cast<long long>(nb) * strips) * kSW;
    const int cols = min(kSW, wd - c0);
    const int rows = rb - ra + 2 * P;  // P rows: the run and its halo
    // g pixel (c0 - P) of the image's first row; the chunks inside the image
    const T* gcol = g + (static_cast<long long>(nb) * h * wd + c0 - P) * kCO;
    unsigned inside = 0;
#pragma unroll
    for (int j = 0; j < NCP; ++j) {
      const int gc = c0 - P + (qof[j] >> 6);  // qof / kCO: the pixel
      inside |= (qof[j] >= 0 && gc >= 0 && gc < wd) ? 1u << j : 0u;
    }

    // g row ra - P + t into stage t % kStages (zeros outside the image)
    auto load = [&](int t) {
      const int gr = ra - P + t;
      const unsigned ok = gr >= 0 && gr < h ? inside : 0u;
      const T* grow = gcol + static_cast<long long>(gr) * wd * kCO;
      const uint32_t dst = stages + (t % kStages) * lay.stage;
#pragma unroll
      for (int j = 0; j < NCP; ++j) {
        if (qof[j] < 0) break;
        const bool in = (ok >> j) & 1u;
        cp_async16(dst + soff[j], in ? grow + qof[j] : g, in ? 16 : 0);
      }
    };
    // dx row ra + t - 2P from its segment in shared memory, in 16-byte packs
    auto store = [&](int t) {
      const int r = ra + t - 2 * P;
      T* drow = dx + ((static_cast<long long>(nb) * h + r) * wd + c0) * CI;
      const int shift =
          static_cast<int>((reinterpret_cast<uintptr_t>(drow) & 15) / sizeof(T));
      const T* seg = reinterpret_cast<const T*>(smem + lay.outs + (t & 1) * lay.seg);
      const int len = cols * CI;
      for (int q = tid; q < (shift + len + V - 1) / V; q += NTH) {
        const int e0 = q * V - shift;
        if (e0 >= 0 && e0 + V <= len) {
          *reinterpret_cast<uint4*>(drow + e0) = *reinterpret_cast<const uint4*>(seg + q * V);
        } else {
          for (int x = 0; x < V; ++x) {
            const int e = e0 + x;
            if (e >= 0 && e < len) drow[e] = seg[q * V + x];
          }
        }
      }
    };

#pragma unroll 1
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < rows) load(t);
      cp_async_commit();
    }
    int slot = 0;  // P ring slot of row t: t % K
#pragma unroll 1
    for (int t = 0; t < rows; ++t) {
      cp_async_wait<kStages - 2>();  // this thread's copies of row t
      __syncthreads();  // everyone's; stage t - 1, the ring slot and segment t + 1 are free
      if (t + kStages - 1 < rows) load(t + kStages - 1);
      cp_async_commit();
      if (t > 2 * P) store(t - 1);  // the previous dx row

      // P row t: this warp's 16 pixels (clamped reads past QC are dropped)
      const uint32_t stage = stages + (t % kStages) * lay.stage;
      float acc[NT][4] = {};
      if constexpr (kBF) {
        const int q = min(m0 + (lane & 7) + (lane & 8), QC - 1);
        const uint32_t base = stage + q * PIX;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, base + ((((ks << 1) | (lane >> 4)) ^ (q & 7)) << 4));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, bw[ks][nt][0], bw[ks][nt][1]);
        }
      } else {
        // g = hi + lo, W' = Hi + Lo: hi . Hi on TF32 m16n8k8, and lo . Hi +
        // hi . Lo as ONE bf16 m16n8k16 product over 16 k slots: this
        // thread's slots 2 tig, 2 tig + 1 hold lo at channels tig, tig + 4 of
        // the k-step (against Hi), slots 2 tig + 8, + 9 hold hi (against
        // Lo). The cross terms are 2^-11 of the product, so bf16's 2^-9
        // rounding of them errs by ~2^-20 of it; their sum is kept apart
        // (a shorter chain) and added last
        float small[NT][4] = {};
        const float* st = reinterpret_cast<const float*>(smem + (t % kStages) * lay.stage);
        const int q0 = min(m0 + gid, QC - 1);
        const int q1 = min(m0 + gid + 8, QC - 1);
        const float* r0 = st + q0 * kCO + tig;
        const float* r1 = st + q1 * kCO + tig;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // a[0] = A[gid][tig], a[1] = A[gid + 8][tig], a[2], a[3] at tig + 4
          uint32_t hi[4], lo[4];
          split_tf32(r0[((2 * ks) ^ (q0 & 7)) << 2], hi[0], lo[0]);
          split_tf32(r1[((2 * ks) ^ (q1 & 7)) << 2], hi[1], lo[1]);
          split_tf32(r0[((2 * ks + 1) ^ (q0 & 7)) << 2], hi[2], lo[2]);
          split_tf32(r1[((2 * ks + 1) ^ (q1 & 7)) << 2], hi[3], lo[3]);
          const uint32_t cross[4] = {pack_f32x2(lo[0], lo[2]), pack_f32x2(lo[1], lo[3]),
                                     pack_f32x2(hi[0], hi[2]), pack_f32x2(hi[1], hi[3])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint4 f = wfrag[(ks * NT + nt) * 32 + lane];
            mma_bf16(small[nt], cross, f.z, f.w);
            mma_tf32(acc[nt], hi, f.x, f.y);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[nt][x] += small[nt][x];
        }
      }
      float* prow = ring + slot * QC * PS;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = m0 + gid + 8 * half;
          if (q < QC) {
            if (j < KKC) prow[q * PS + j] = acc[nt][2 * half];
            if (j + 1 < KKC) prow[q * PS + j + 1] = acc[nt][2 * half + 1];
          }
        }
      }
      __syncthreads();  // P row t is in the ring

      if (t >= 2 * P && tid < kSW) {
        // dx row ra + t - 2P, pixel tid, from P rows t - 2P .. t (slots
        // slot - u): dx[i] = sum_{u, v} P[t - u][tid + 2P - v][(u K + v) CI + i]
        float s[CI];
#pragma unroll
        for (int i = 0; i < CI; ++i) s[i] = 0.f;
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int su = slot - u < 0 ? slot - u + K : slot - u;
          const float* pr = ring + (su * QC + tid + 2 * P) * PS + u * K * CI;
#pragma unroll
          for (int v = 0; v < K; ++v) {
#pragma unroll
            for (int i = 0; i < CI; ++i) s[i] += pr[v * (CI - PS) + i];
          }
        }
        if (tid < cols) {
          const int shift = static_cast<int>(
              (reinterpret_cast<uintptr_t>(
                   dx + ((static_cast<long long>(nb) * h + ra + t - 2 * P) * wd + c0) * CI) &
               15) / sizeof(T));
          T* seg = reinterpret_cast<T*>(smem + lay.outs + (t & 1) * lay.seg);
#pragma unroll
          for (int i = 0; i < CI; ++i) seg[shift + tid * CI + i] = from_f32<T>(s[i]);
        }
      }
      slot = slot + 1 == K ? 0 : slot + 1;
    }
    __syncthreads();  // the last segment is written
    if (rows > 2 * P) store(rows - 1);
  }
}

}  // namespace tp

// occupancy != nullptr: report the blocks an SM holds instead of launching
template <typename T, int K, int CI>
cudaError_t tp_launch(const void* g, const void* w, void* dx, int n, int h,
                      int wd, int blocks, cudaStream_t stream, int* occupancy) {
  auto kernel = tp::conv_dx_tap_packed<T, K, CI>;
  constexpr int smem = tp::layout(K, CI, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel,
                                                         tp::nthreads(K), smem);
  }
  const int strips = (wd + tp::kSW - 1) / tp::kSW;
  kernel<<<blocks, tp::nthreads(K), smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx),
      h, wd, strips, static_cast<long long>(n) * strips * h);
  return cudaGetLastError();
}

// the shapes the kernel takes: C_out = 64, (k, C_in) in (3, 1..3), (5, 1)
// (k * k * C_in <= 32 with k >= 3)
template <typename T>
cudaError_t tp_launch_t(int k, int ci, const void* g, const void* w, void* dx,
                        int n, int h, int wd, int blocks, cudaStream_t stream,
                        int* occupancy) {
  if (k == 3 && ci == 1) return tp_launch<T, 3, 1>(g, w, dx, n, h, wd, blocks, stream, occupancy);
  if (k == 3 && ci == 2) return tp_launch<T, 3, 2>(g, w, dx, n, h, wd, blocks, stream, occupancy);
  if (k == 3 && ci == 3) return tp_launch<T, 3, 3>(g, w, dx, n, h, wd, blocks, stream, occupancy);
  if (k == 5 && ci == 1) return tp_launch<T, 5, 1>(g, w, dx, n, h, wd, blocks, stream, occupancy);
  return cudaErrorInvalidValue;
}

bool tp_takes(int ci, int co, int k) {
  return co == tp::kCO && k >= 3 && k % 2 == 1 && ci >= 1 && k * k * ci <= 32;
}

}  // namespace

// Shared memory (bytes) one block of the kernel needs; the wrapper checks it
// against the card's per-block limit before launching.
extern "C" long long fnst_conv_same_bwd_smem(int k, int ci, int full) {
  return (long long)smem_bytes(k, 4 * ((ci + 3) / 4), ci, full != 0);
}

// g: (n, h, w, co) NHWC; x: (n, h, w, ci) NHWC (read only when full);
// both in one dtype, f32 or bf16 (is_bf16). wpk: (co, k * k, ci4) f32 with
// wpk[o, u * k + v, i] = w[o, i, u, v] and zeros for i >= ci, ci4 = 4 *
// ceil(ci / 4). dx: (n, h, w, ci) out, g's dtype. Full mode: work is
// (blocks, (k * k * ci + 1) * co) f32 zeroed scratch, dwb the
// ((k * k * ci + 1) * co) f32 output (dw as (k * k, ci, co), then db). dx-only
// mode: blocks is the tile count, work and dwb are unused. Launches on
// ``stream``; returns the CUDA error code (0 on success). Allocates nothing.
extern "C" int fnst_conv_same_bwd(const void* g, const void* x,
                                  const void* wpk, void* dx, void* work,
                                  void* dwb, int n, int h, int w, int ci,
                                  int co, int k, int full, int blocks,
                                  int is_bf16, void* stream) {
  Geo geo;
  geo.n = n;
  geo.h = h;
  geo.w = w;
  geo.ci = ci;
  geo.co = co;
  geo.ci4 = 4 * ((ci + 3) / 4);
  geo.tiles_h = (h + kTH - 1) / kTH;
  geo.tiles_w = (w + kTW - 1) / kTW;
  const float* wp = static_cast<const float*>(wpk);
  float* wk = static_cast<float*>(work);
  float* out = static_cast<float*>(dwb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return full ? launch_t<__nv_bfloat16, true>(k, g, x, wp, dx, wk, out, geo, blocks, st)
                : launch_t<__nv_bfloat16, false>(k, g, x, wp, dx, wk, out, geo, blocks, st);
  }
  return full ? launch_t<float, true>(k, g, x, wp, dx, wk, out, geo, blocks, st)
              : launch_t<float, false>(k, g, x, wp, dx, wk, out, geo, blocks, st);
}

// The tap-packed dx kernel's dynamic shared memory (bytes) for k, ci and
// the dtype; -1 outside its shapes.
extern "C" long long fnst_conv_dx_tap_packed_smem(int k, int ci, int is_bf16) {
  if (!tp_takes(ci, tp::kCO, k)) return -1;
  return tp::layout(k, ci, is_bf16 ? 2 : 4).total;
}

// Blocks of the tap-packed dx kernel one SM holds at once (k, ci, dtype);
// a negative CUDA error code if the query fails.
extern "C" int fnst_conv_dx_tap_packed_occupancy(int k, int ci, int is_bf16) {
  if (!tp_takes(ci, tp::kCO, k)) return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t err =
      is_bf16 ? tp_launch_t<__nv_bfloat16>(k, ci, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, &per_sm)
              : tp_launch_t<float>(k, ci, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, &per_sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// dx of the tap-packed route. g: (n, h, w, co) NHWC, 16-byte aligned; w:
// (co, ci, k, k) OIHW contiguous in g's dtype (f32 or bf16: is_bf16); dx:
// (n, h, w, ci) NHWC out, g's dtype. co = 64; (k, ci) in (3, 1..3), (5, 1).
// blocks: the grid (one wave: SMs x the occupancy). Launches on
// ``stream``; returns the CUDA error code (0 on success). Allocates nothing.
extern "C" int fnst_conv_dx_tap_packed(const void* g, const void* w, void* dx,
                                       int n, int h, int wd, int ci, int co,
                                       int k, int blocks, int is_bf16,
                                       void* stream) {
  if (!tp_takes(ci, co, k) || n < 1 || h < 1 || wd < 1 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(g) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tp_launch_t<__nv_bfloat16>(k, ci, g, w, dx, n, h, wd, blocks, st, nullptr)
                 : tp_launch_t<float>(k, ci, g, w, dx, n, h, wd, blocks, st, nullptr);
}
