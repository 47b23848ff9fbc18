// Instance-norm forward and backward with the affine and an optional ReLU,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel fast_neural_style_transfer_tpu/ops/pallas_norm.py::
// _in_fwd_kernel (launched by _pallas_in_forward). For each (sample n, channel c)
// of an NHWC activation x it computes the f32 mean and biased variance over
// H*W, inv = rsqrt(var + eps), y = x * (inv * gamma) + (beta - mean * inv *
// gamma), then an optional ReLU. y is written in x's dtype; mean and inv are
// written as (N, C) f32 residuals.
//
// Bound: bytes. The work is ~8 flops per element against 2 bytes (bf16) or
// 4 bytes (f32) read and the same written, far below the card's ~295
// flops/byte balance point, so the least time is (read x once + write y
// once) over the 3.35 TB/s of HBM. One 256x256 stylizer forward has
// 13 * 1,048,576 + 2,097,152 = 15,728,640 IN elements: 62.9 MB of bf16
// traffic, 18.8 us at B=1 and 150 us at B=8 (f32 doubles both). At B=1
// every slab (<= 8.4 MB) fits the 50 MB L2 and launch latency dominates.
//
// Design. The TPU kernel ran one sequential grid step per (sample, channel
// block) with the whole H*W slab in VMEM; at batch 1 that would put the
// 256x256x32 decoder IN on a single block of the 132 SMs. Here H*W is split
// across blocks and the statistics are reduced in two launches:
//   1. in_stats_partial: a block owns (sample, pixel chunk, tile of <= 32
//      channels). Neighbouring threads sit on neighbouring channels, so each
//      warp reads one contiguous run of the NHWC row. Each thread accumulates
//      f32 Welford (count, mean, M2) over its pixels (or sum, sum of squares
//      in one-pass mode); the block merges its 8 pixel lanes with Chan's
//      formula in shared memory and writes one partial per (n, chunk, c) to
//      an f32 workspace the caller allocates.
//   2. in_apply: every block of the same grid merges its channels' chunk
//      partials into mean and var = M2 / HW (one-pass: max(E[x^2] - mean^2,
//      0), exactly the TPU kernel's arithmetic), the first chunk's block
//      writes the residuals, and each block writes y for its own chunk.
// The chunk count per (sample, channel tile) is capped (the wrapper picks
// it), so the partials that every apply block re-reads stay a few KB.
//
// Backward (fnst_instance_norm_bwd). Replaces the TPU kernel
// fast_neural_style_transfer_tpu/ops/pallas_norm.py::_in_bwd_kernel
// (launched by _pallas_in_backward, VJP _fused_in_bwd). From x, the upstream
// gradient g (already in x's dtype), the forward's (mean, inv) residuals and
// the affine (gamma, beta):
//   xhat = (x - mean) * inv;  with ReLU, g <- g * [xhat * gamma + beta > 0]
//   dx   = gamma * inv * (g - sum(g) / HW - xhat * sum(g * xhat) / HW)
//   per-sample dgamma = sum(g * xhat), dbeta = sum(g)  ((N, C) f32; the
//   wrapper sums them over N).
// The ReLU mask is rebuilt from x in f32 with every operation rounded on its
// own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), so it equals the
// plain PyTorch version's mask bit for bit on the same inputs. y is never
// saved: where the forward rounded y to bf16 next to 0, the mask may differ
// from relu(y) > 0, as it does in the TPU kernel.
// Bound: bytes. Read x and g once, write dx once: 3 * 2 B (bf16) per element,
// 15,728,640 IN elements per 256x256 image, so 1.89 GB and 0.56 ms at B=20
// bf16 over 3.35 TB/s (f32 doubles it). The two reductions force a second
// read of x and g, which launch 2 makes (from L2 where the slab fits).
// Design: the forward's chunked two-launch layout.
//   1. in_bwd_partial: a block owns (sample, pixel chunk, tile of <= 32
//      channels); each thread sums the gated g and g * xhat over its pixels
//      in f32, the block adds its 8 pixel lanes and writes one partial pair
//      per (n, chunk, c) to an f32 workspace (2, N, chunks, C).
//   2. in_bwd_apply: every block adds its channels' chunk partials, the
//      first chunk's block writes the per-sample dgamma / dbeta, and each
//      block writes dx for its own chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileC = 32;  // channels per block: one warp spans a tile row
constexpr int kLanes = 8;   // pixel lanes per block: 256 threads

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

// Merge the moments (nb, ab, bb) into (na, aa, ba). One-pass: a and b are
// the sum and the sum of squares. Welford: a is the mean and b is M2,
// merged with Chan et al.'s formula.
template <bool kOnePass>
__device__ __forceinline__ void merge(float& na, float& aa, float& ba,
                                      float nb, float ab, float bb) {
  if (kOnePass) {
    na += nb;
    aa += ab;
    ba += bb;
    return;
  }
  if (nb == 0.f) return;
  const float n = na + nb;
  const float d = ab - aa;
  const float f = nb / n;
  aa += d * f;
  ba += bb + d * d * na * f;
  na = n;
}

template <typename T, bool kOnePass>
__global__ void __launch_bounds__(kTileC * kLanes)
    in_stats_partial(const T* __restrict__ x, float* __restrict__ work,
                     int n, int hw, int c, int chunk, int chunks) {
  const int cx = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kTileC + cx;
  const int s = blockIdx.z;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(p0 + chunk, hw);

  float cnt = 0.f, a = 0.f, b = 0.f;
  if (ch < c) {
    const T* xs = x + (size_t)s * hw * c + ch;
#pragma unroll 4
    for (int p = p0 + ly; p < p1; p += kLanes) {
      const float v = to_f32(xs[(size_t)p * c]);
      cnt += 1.f;
      if (kOnePass) {
        a += v;
        b += v * v;
      } else {
        const float d = v - a;
        a += d / cnt;
        b += d * (v - a);
      }
    }
  }

  __shared__ float sh[3][kLanes][kTileC];
  sh[0][ly][cx] = cnt;
  sh[1][ly][cx] = a;
  sh[2][ly][cx] = b;
  __syncthreads();
  if (ly != 0 || ch >= c) return;
  for (int l = 1; l < kLanes; ++l) {
    merge<kOnePass>(cnt, a, b, sh[0][l][cx], sh[1][l][cx], sh[2][l][cx]);
  }
  const size_t plane = (size_t)n * chunks * c;
  const size_t slot = ((size_t)s * chunks + blockIdx.x) * c + ch;
  work[slot] = cnt;
  work[plane + slot] = a;
  work[2 * plane + slot] = b;
}

template <typename T, bool kOnePass>
__global__ void __launch_bounds__(kTileC * kLanes)
    in_apply(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ work,
             T* __restrict__ y, float* __restrict__ mean_out,
             float* __restrict__ inv_out, int n, int hw, int c, int chunk,
             int chunks, float eps, int relu) {
  const int cx = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kTileC + cx;
  const int s = blockIdx.z;

  // finalize: each pixel lane merges every kLanes-th chunk partial
  float cnt = 0.f, a = 0.f, b = 0.f;
  if (ch < c) {
    const size_t plane = (size_t)n * chunks * c;
    for (int j = ly; j < chunks; j += kLanes) {
      const size_t slot = ((size_t)s * chunks + j) * c + ch;
      merge<kOnePass>(cnt, a, b, work[slot], work[plane + slot],
                      work[2 * plane + slot]);
    }
  }
  __shared__ float sh[3][kLanes][kTileC];
  __shared__ float s_scale[kTileC];
  __shared__ float s_shift[kTileC];
  sh[0][ly][cx] = cnt;
  sh[1][ly][cx] = a;
  sh[2][ly][cx] = b;
  __syncthreads();
  if (ly == 0 && ch < c) {
    for (int l = 1; l < kLanes; ++l) {
      merge<kOnePass>(cnt, a, b, sh[0][l][cx], sh[1][l][cx], sh[2][l][cx]);
    }
    const float fhw = (float)hw;
    float mean, var;
    if (kOnePass) {
      mean = a / fhw;
      var = fmaxf(b / fhw - mean * mean, 0.f);
    } else {
      mean = a;
      var = b / fhw;
    }
    const float inv = rsqrtf(var + eps);
    const float scale = inv * gamma[ch];
    s_scale[cx] = scale;
    s_shift[cx] = beta[ch] - mean * scale;
    if (blockIdx.x == 0) {
      mean_out[(size_t)s * c + ch] = mean;
      inv_out[(size_t)s * c + ch] = inv;
    }
  }
  __syncthreads();
  if (ch >= c) return;

  const float scale = s_scale[cx];
  const float shift = s_shift[cx];
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(p0 + chunk, hw);
  const size_t base = (size_t)s * hw * c + ch;
#pragma unroll 4
  for (int p = p0 + ly; p < p1; p += kLanes) {
    const size_t i = base + (size_t)p * c;
    float v = to_f32(x[i]) * scale + shift;
    if (relu) v = fmaxf(v, 0.f);
    y[i] = from_f32<T>(v);
  }
}

template <typename T, bool kOnePass>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, float* mean, float* inv, float* work, int n,
                   int hw, int c, int chunk, int chunks, float eps, int relu,
                   cudaStream_t stream) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid(chunks, (c + kTileC - 1) / kTileC, n);
  in_stats_partial<T, kOnePass><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), work, n, hw, c, chunk, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_apply<T, kOnePass><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, work, static_cast<T*>(y), mean,
      inv, n, hw, c, chunk, chunks, eps, relu);
  return cudaGetLastError();
}

// xhat and the ReLU-gated gradient of one element, each operation rounded
// on its own so the mask matches the plain version's exactly.
__device__ __forceinline__ void gate(float xv, float gv, float m, float iv,
                                     float ga, float be, int relu,
                                     float& xh, float& gg) {
  xh = __fmul_rn(__fsub_rn(xv, m), iv);
  gg = (relu && !(__fadd_rn(__fmul_rn(xh, ga), be) > 0.f)) ? 0.f : gv;
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kLanes)
    in_bwd_partial(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ work,
                   int n, int hw, int c, int chunk, int chunks, int relu) {
  const int cx = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kTileC + cx;
  const int s = blockIdx.z;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(p0 + chunk, hw);

  float sg = 0.f, sgx = 0.f;
  if (ch < c) {
    const float m = mean[(size_t)s * c + ch];
    const float iv = inv[(size_t)s * c + ch];
    const float ga = gamma[ch];
    const float be = beta[ch];
    const size_t base = (size_t)s * hw * c + ch;
#pragma unroll 4
    for (int p = p0 + ly; p < p1; p += kLanes) {
      const size_t i = base + (size_t)p * c;
      float xh, gg;
      gate(to_f32(x[i]), to_f32(g[i]), m, iv, ga, be, relu, xh, gg);
      sg += gg;
      sgx += gg * xh;
    }
  }

  __shared__ float sh[2][kLanes][kTileC];
  sh[0][ly][cx] = sg;
  sh[1][ly][cx] = sgx;
  __syncthreads();
  if (ly != 0 || ch >= c) return;
  for (int l = 1; l < kLanes; ++l) {
    sg += sh[0][l][cx];
    sgx += sh[1][l][cx];
  }
  const size_t plane = (size_t)n * chunks * c;
  const size_t slot = ((size_t)s * chunks + blockIdx.x) * c + ch;
  work[slot] = sg;
  work[plane + slot] = sgx;
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kLanes)
    in_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ work, T* __restrict__ dx,
                 float* __restrict__ dgamma, float* __restrict__ dbeta, int n,
                 int hw, int c, int chunk, int chunks, int relu) {
  const int cx = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kTileC + cx;
  const int s = blockIdx.z;

  // each pixel lane adds every kLanes-th chunk partial, then lane 0 the lanes
  float sg = 0.f, sgx = 0.f;
  if (ch < c) {
    const size_t plane = (size_t)n * chunks * c;
    for (int j = ly; j < chunks; j += kLanes) {
      const size_t slot = ((size_t)s * chunks + j) * c + ch;
      sg += work[slot];
      sgx += work[plane + slot];
    }
  }
  __shared__ float sh[2][kLanes][kTileC];
  __shared__ float s_a[kTileC];
  __shared__ float s_b[kTileC];
  sh[0][ly][cx] = sg;
  sh[1][ly][cx] = sgx;
  __syncthreads();
  if (ly == 0 && ch < c) {
    for (int l = 1; l < kLanes; ++l) {
      sg += sh[0][l][cx];
      sgx += sh[1][l][cx];
    }
    const float fhw = (float)hw;
    s_a[cx] = sg / fhw;
    s_b[cx] = sgx / fhw;
    if (blockIdx.x == 0) {
      dgamma[(size_t)s * c + ch] = sgx;
      dbeta[(size_t)s * c + ch] = sg;
    }
  }
  __syncthreads();
  if (ch >= c) return;

  const float m = mean[(size_t)s * c + ch];
  const float iv = inv[(size_t)s * c + ch];
  const float ga = gamma[ch];
  const float be = beta[ch];
  const float scale = ga * iv;
  const float a = s_a[cx];
  const float b = s_b[cx];
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(p0 + chunk, hw);
  const size_t base = (size_t)s * hw * c + ch;
#pragma unroll 4
  for (int p = p0 + ly; p < p1; p += kLanes) {
    const size_t i = base + (size_t)p * c;
    float xh, gg;
    gate(to_f32(x[i]), to_f32(g[i]), m, iv, ga, be, relu, xh, gg);
    dx[i] = from_f32<T>(scale * (gg - a - xh * b));
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* mean,
                       const float* inv, const float* gamma,
                       const float* beta, void* dx, float* dgamma,
                       float* dbeta, float* work, int n, int hw, int c,
                       int chunk, int chunks, int relu, cudaStream_t stream) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid(chunks, (c + kTileC - 1) / kTileC, n);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  in_bwd_partial<T><<<grid, block, 0, stream>>>(
      xt, gt, mean, inv, gamma, beta, work, n, hw, c, chunk, chunks, relu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_apply<T><<<grid, block, 0, stream>>>(
      xt, gt, mean, inv, gamma, beta, work, static_cast<T*>(dx), dgamma,
      dbeta, n, hw, c, chunk, chunks, relu);
  return cudaGetLastError();
}

}  // namespace

// x, y: (n, hw, c) NHWC, f32 or bf16 (is_bf16). gamma, beta: (c,) f32.
// mean, inv: (n, c) f32 out. work: (3, n, chunks, c) f32 scratch.
// chunks = ceil(hw / chunk). Launches on ``stream``; returns the CUDA error
// code of the launches (0 on success). Allocates nothing.
extern "C" int fnst_instance_norm_fwd(const void* x, const void* gamma,
                                      const void* beta, void* y, void* mean,
                                      void* inv, void* work, int n, int hw,
                                      int c, int chunk, int chunks, float eps,
                                      int relu, int onepass, int is_bf16,
                                      void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(inv);
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return onepass ? launch<__nv_bfloat16, true>(x, g, b, y, m, iv, w, n, hw,
                                                 c, chunk, chunks, eps, relu, st)
                   : launch<__nv_bfloat16, false>(x, g, b, y, m, iv, w, n, hw,
                                                  c, chunk, chunks, eps, relu, st);
  }
  return onepass ? launch<float, true>(x, g, b, y, m, iv, w, n, hw, c, chunk,
                                       chunks, eps, relu, st)
                 : launch<float, false>(x, g, b, y, m, iv, w, n, hw, c, chunk,
                                        chunks, eps, relu, st);
}

// x, g, dx: (n, hw, c) NHWC in one dtype, f32 or bf16 (is_bf16). mean, inv:
// (n, c) f32 residuals of the forward. gamma, beta: (c,) f32. dgamma, dbeta:
// (n, c) f32 out, per sample. work: (2, n, chunks, c) f32 scratch.
// chunks = ceil(hw / chunk). Launches on ``stream``; returns the CUDA error
// code of the launches (0 on success). Allocates nothing.
extern "C" int fnst_instance_norm_bwd(const void* x, const void* g,
                                      const void* mean, const void* inv,
                                      const void* gamma, const void* beta,
                                      void* dx, void* dgamma, void* dbeta,
                                      void* work, int n, int hw, int c,
                                      int chunk, int chunks, int relu,
                                      int is_bf16, void* stream) {
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16>(x, g, m, iv, ga, be, dx, dg, db, w, n,
                                     hw, c, chunk, chunks, relu, st);
  }
  return launch_bwd<float>(x, g, m, iv, ga, be, dx, dg, db, w, n, hw, c,
                           chunk, chunks, relu, st);
}
