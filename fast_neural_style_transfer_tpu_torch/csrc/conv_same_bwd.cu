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
// Gate (set by this kernel, not by the TPU's tiling): odd k <= 11, stride
// 1, k * k * C_in <= 128, any H and W, any C_out. The wrapper
// (ops/cuda_conv.py) raises outside it.
//
// Bound: bytes. dx-only reads g once and writes dx once: at B=20, 256x256,
// bf16, 167.8 MB + 7.9 MB, 0.052 ms over 3.35 TB/s. Its 2 * 27 * 64 = 3456
// flops per pixel stay under the bf16 tensor-core rate's time for those
// bytes, and under the f32 rate's time for the f32 bytes.
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
// Design (simple first; the shape of a faster kernel is in PERF.md). One
// block of 8 x 32 threads owns an 8 x 32 tile of output pixels, one pixel a
// thread. For each group of 4 input channels and each chunk of 32 output
// channels it stages in shared memory:
//   gs: the chunk of g over the tile plus a p-pixel halo, converted to f32
//       and stored [row][channel][column], with an odd column stride, so the
//       warp's 32 columns fall on 32 banks;
//   ws: the chunk's weights [o][u * k + v][i], read as float4 broadcasts.
// Each thread then accumulates its 4 dx values over k * k * 32 products.
// The TPU kernel's tap-packed matmul and sequential halo skew have no
// counterpart: blocks run in no order, so each stages its own halo (the
// re-read halo rows come from L2).
// Full mode (dw and db as well) runs a persistent grid of at most
// 4 * 132 blocks over the tiles. Each block also stages its tile of x with
// the halo, and each thread owns some (u, v, i, o) entries of dw (and db),
// summing x * g over the tile's pixels into the block's row of an f32
// workspace (zeroed by the wrapper). A second short launch adds the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
