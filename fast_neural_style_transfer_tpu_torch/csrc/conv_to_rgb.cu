// The stylizer's last convolution, 32 -> 3 channels, 9 x 9, stride 1, on
// the tensor cores of Hopper (sm_90a).
//
// fnst_conv_to_rgb writes y = conv(xp, w) + b: xp the reflect-padded input
// (N, H + 8, W + 8, 32) NHWC bf16 (what ops/cuda_pad.py's pad_pixels
// stages), w (3, 32, 9, 9) bf16 at any strides (the serving nets keep
// theirs channels_last), b (3,) bf16 or none, y (N, H, W, 3) NHWC bf16 (a
// channels_last (N, 3, H, W) tensor). A product of two bf16 values is exact
// in fp32, every sum is taken in fp32, the bias is added in fp32 and the
// result rounded once to bf16: what cuDNN's TF32 implicit GEMM computed for
// this conv (bf16 operands are exact in TF32); only the order of the sums
// differs. ops/conv.py::reflect_conv2d routes the stylenet's final_conv
// here in a bf16 forward that needs no gradient.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA. It was
// added because cuDNN runs it, a GEMM whose N is 3, on a TF32 kernel with a
// 64-wide tile: ~3.1 ms of a B = 8 512^2 forward's ~11 ms of device time,
// at ~1.4 % of its bound.
//
// Bound: bytes, just. A pixel takes 2 * 3 * 32 * 81 operations: 32.6 GFLOP
// at B = 8 and 512^2, 0.033 ms at 989 TFLOP/s; x (134 MB before the pad)
// read once and y (12.6 MB) written once take 0.044 ms at 3.35 TB/s.
//
// The product. Write u, v for the vertical and horizontal tap, ci for the
// input channel, o for the output one. For one input row s, the GEMM
//     P_u[col, (v, o)] = sum_ci xp[s, col, ci] w[o, ci, u, v]
// has M = the strip's input columns, K = 32 channels and N = the 27 pairs
// (v, o), padded to 32, so 84 % of the tensor cores' products are useful
// (a GEMM with N = the 3 outputs would use 3 of 8). Output row r is
//     y[r, c, o] = b[o] + sum_u sum_v P_u(s = r + u)[c + v, (v, o)]:
// the vertical sum accumulates in the MMA's fp32 accumulators (one set a
// row, the nine P_u of rows r .. r + 8 added into it), the horizontal sum
// runs once an output row is complete, through shared memory. Partial sums
// stay in fp32 until the store (rounding them to bf16 would not hold the
// port's tolerances; the conv-dx kernel found the same).
//
// Design. A block is 8 warps on strips of 112 input columns (kCols; up to
// 104 output columns, kStrip: the planner splits a row into even strips).
// It runs through a fixed number of output rows of the (image, strip)
// columns taken in turn, so that the card's SMs get equal runs, one block
// an SM in one wave; a run that crosses a column's end starts the next
// column's rows afresh. Down a column it walks two output rows (a pass) at
// a time. Warp w < 7 owns the strip's input columns 16w .. 16w + 15: the
// M = 16 of mma.sync m16n8k16 (bf16 in, fp32 accumulators). Every such
// warp holds all of w in registers, 9 taps x 2 K halves x 4 N tiles of B
// fragments (144 registers), loaded once a block, so the products read
// shared memory only for the A fragments: for a pass, the ten input rows
// r .. r + 9 give two ldmatrix.x4 each, and each feeds 8 MMAs into the
// accumulators of row r (tap u = s - r) and 8 into those of row r + 1
// (u = s - r - 1) where u lies in 0 .. 8: 144 MMAs a warp a pass for 20 A
// loads. The input rows stream through a ring of kStages rows of the strip
// (112 pixels x 64 bytes = 7 KB each) by 16-byte cp.async from every
// thread, one commit group a row, kStages - 12 rows ahead of the rows a
// pass reads; columns and rows past the image land as zeros (cp.async's
// zero fill). Pixel p's 16-byte chunk c lies at chunk c ^ ((p >> 1) & 3) of
// its 64 bytes (the layout of the 64-byte swizzle), so that the 8 rows an
// ldmatrix phase reads fall in 32 distinct banks. At the end of a pass each
// product warp writes its accumulators, fp32, to one of two epilogue
// buffers, transposed ((v, o) major, 116 floats a column: conflict-free
// both ways). The eighth warp owns the horizontal sums: after the next
// pass's barrier it sums the 9 taps of each output pixel's 3 channels from
// the buffer, adds the bias, rounds and stores, while the seven product
// warps run that pass's MMAs (the sums took ~20 % of the kernel's time when
// the product warps ran them between passes). One barrier a pass: it makes
// the pass's rows visible, frees the previous pass's two rows for the
// refill and its epilogue buffer for the sums. A warp whose columns feed no
// output of the image runs no products. 180,992 bytes of shared memory and
// up to 255 registers a thread: one block an SM. ops/cuda_conv_rgb.py::
// plan_rgb picks the strip and the run from the card's SM count.
//
// Measured at B = 8 and 512^2 (H100 SXM at 700 W, CUDA events): 0.144-0.147
// ms, 30 % of the bound, against 3.6 ms for cuDNN's conv of the same bf16
// operands; the products alone take 0.129 ms, so mma.sync's issue rate
// bounds it and the loads hide behind it (wgmma is the next step). On the
// way: 0.182 ms with one block a (strip, 172 rows) in a
// wave of 120 blocks, 0.168 with equal runs on all 132 SMs, 0.144 with the
// sums on their own warp; four rows a pass, more ring stages and other
// orders of the MMAs moved it by 3 % or less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 32;                   // input channels
constexpr int kCout = 3;                   // output channels
constexpr int kTaps = 9;                   // the kernel's side
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMmaWarps = kWarps - 1;      // warps on the products; the last sums
constexpr int kCols = 16 * kMmaWarps;      // input columns of a strip
constexpr int kStrip = kCols - (kTaps - 1);  // output columns of a strip
constexpr int kPass = 2;                   // output rows a pass
constexpr int kPassRows = kPass + kTaps - 1;  // input rows a pass reads
constexpr int kStages = 18;                // input rows in the ring
constexpr int kAhead = kStages - kPassRows - kPass;  // rows in flight past a pass's
constexpr int kRowBytes = kCols * kCin * 2;  // one input row of the strip
constexpr int kUsedN = kTaps * kCout;      // 27 useful (v, o) columns
constexpr int kEpiN = 28;                  // (v, o) columns kept (27 and a pad)
constexpr int kEpiStride = kCols + 4;      // floats of one (v, o) column
constexpr int kEpiFloats = kPass * kEpiN * kEpiStride;
constexpr int kSmemBytes = kStages * kRowBytes + 2 * kEpiFloats * 4;
constexpr int kWeights = kCout * kCin * kTaps * kTaps;

static_assert(kAhead >= 2, "the ring holds too few rows");
static_assert(kCols * 4 <= 2 * kThreads, "a row's 16-byte chunks, two a thread");
static_assert(kWeights * 2 <= 2 * kEpiFloats * 4, "weights staged in the epilogue buffers");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geo {
  int h, w;           // output rows and columns
  int strip;          // output columns of a strip (<= kStrip)
  int strips;         // strips across a row
  long long total;    // output rows of all (image, strip) columns: n * strips * h
  int rows;           // of those, a block's run
  int ws_o, ws_i, ws_u, ws_v;  // the weight's strides, in elements
  int has_bias;
};

__global__ void __launch_bounds__(kThreads, 1)
    conv_to_rgb_kernel(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ wt,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                       Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* epi = reinterpret_cast<float*>(smem + kStages * kRowBytes);
  uint16_t* wstage = reinterpret_cast<uint16_t*>(epi);  // before the first pass only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hp = g.h + kTaps - 1, wp = g.w + kTaps - 1;
  const uint32_t ring = smem_u32(smem);

  // the weights, staged in canonical (o, ci, u, v) order, then each
  // thread's B fragments: b[u][kk][nt] holds K = ci 16 kk + 2 t (+1) and
  // + 8 (+1), N = (v, o) = 8 nt + lane / 4, zero past the 27 used columns
  for (int i = tid; i < kWeights; i += kThreads) {
    const int v = i % kTaps, u = (i / kTaps) % kTaps, ci = (i / (kTaps * kTaps)) % kCin;
    const int o = i / (kTaps * kTaps * kCin);
    wstage[i] = wt[o * g.ws_o + ci * g.ws_i + u * g.ws_u + v * g.ws_v];
  }
  __syncthreads();
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t bf[kTaps][2][4][2];
#pragma unroll
  for (int u = 0; u < kTaps; ++u)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 8 * nt + gq, v = j / kCout, o = j - kCout * v;
          const int ci = 16 * kk + 8 * half + 2 * tq;
          uint32_t lo = 0, hi = 0;
          if (j < kUsedN) {
            lo = wstage[((o * kCin + ci) * kTaps + u) * kTaps + v];
            hi = wstage[((o * kCin + ci + 1) * kTaps + u) * kTaps + v];
          }
          bf[u][kk][nt][half] = lo | (hi << 16);
        }
  const float bias0 = g.has_bias ? __bfloat162float(bias[0]) : 0.f;
  const float bias1 = g.has_bias ? __bfloat162float(bias[1]) : 0.f;
  const float bias2 = g.has_bias ? __bfloat162float(bias[2]) : 0.f;

  // this thread's ldmatrix row address inside an input row, per K half
  const int pa = 16 * warp + (lane & 15);
  uint32_t aoff[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    aoff[kk] = pa * 64 + (((2 * kk + (lane >> 4)) ^ ((pa >> 1) & 3)) << 4);

  // the block's run of output rows, through (image, strip) columns of h
  // rows each in turn: one segment a column it touches
  const long long first = (long long)blockIdx.x * g.rows;
  const long long last = min(first + g.rows, g.total);
  for (long long at = first; at < last;) {
    const long long col = at / g.h;
    const int r0 = static_cast<int>(at - col * g.h);
    const int r1 = static_cast<int>(min((long long)g.h, r0 + (last - at)));
    at += r1 - r0;
    const int n = static_cast<int>(col / g.strips);
    const int c0 = static_cast<int>(col - (long long)n * g.strips) * g.strip;
    const int passes = (r1 - r0 + kPass - 1) / kPass;
    const int in_rows = kPass * passes + kTaps - 1;  // input rows the segment reads
    const __nv_bfloat16* xn = x + (long long)n * hp * wp * kCin;
    // columns 16 warp .. 16 warp + 15 feed outputs max(0, 16 warp - 8) ..
    const int out_cols = min(g.strip, g.w - c0);
    const int in_cols = out_cols + kTaps - 1;
    const bool active = warp < kMmaWarps && max(0, 16 * warp - (kTaps - 1)) < out_cols;

    // input row r0 + i of the strip into ring slot i % kStages; chunks past
    // the strip's input columns or the image's rows as zeros; one commit
    // group either way
    auto load_row = [&](int i) {
      if (i < in_rows) {
        const int s = r0 + i;
        const uint32_t dst = ring + (i % kStages) * kRowBytes;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int chunk = tid + k * kThreads;
          const int p = chunk >> 2, c = chunk & 3;
          if (p >= kCols) break;
          const bool ok = s < hp && p < in_cols;
          const __nv_bfloat16* src = ok ? xn + ((long long)s * wp + c0 + p) * kCin + c * 8 : x;
          cp_async16(dst + p * 64 + ((c ^ ((p >> 1) & 3)) << 4), src, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };

    // the horizontal sums of pass q's rows from epilogue buffer q % 2, a
    // pixel (3 outputs) at a time by threads t0, t0 + step, ...
    auto epilogue = [&](int q, int t0, int step) {
      const float* e = epi + (q & 1) * kEpiFloats;
      for (int idx = t0; idx < kPass * kStrip; idx += step) {
        const int j = idx / kStrip, c = idx - j * kStrip;
        const int r = r0 + kPass * q + j;
        if (c < out_cols && r < r1) {
          const float* cs = e + j * kEpiN * kEpiStride + c;
          float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int v = 0; v < kTaps; ++v) {
            const float* t = cs + v * (kCout * kEpiStride + 1);
            s0 += t[0];
            s1 += t[kEpiStride];
            s2 += t[2 * kEpiStride];
          }
          __nv_bfloat16* out = y + (((long long)n * g.h + r) * g.w + c0 + c) * kCout;
          out[0] = __float2bfloat16_rn(bias0 + s0);
          out[1] = __float2bfloat16_rn(bias1 + s1);
          out[2] = __float2bfloat16_rn(bias2 + s2);
        }
      }
    };

    for (int i = 0; i < kStages; ++i) load_row(i);
    for (int q = 0; q < passes; ++q) {
      cp_async_wait<kAhead>();
      __syncthreads();
      if (q > 0) {  // the previous pass's first rows are free
#pragma unroll
        for (int k = 0; k < kPass; ++k) load_row(kPass * (q - 1) + kStages + k);
      }
      if (active) {
        float acc[kPass][4][4];
#pragma unroll
        for (int j = 0; j < kPass; ++j)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
        const int slot0 = (kPass * q) % kStages;
#pragma unroll
        for (int i = 0; i < kPassRows; ++i) {
          const int slot = slot0 + i < kStages ? slot0 + i : slot0 + i - kStages;
          const uint32_t row = ring + slot * kRowBytes;
          uint32_t a[2][4];
          ldmatrix_x4(a[0], row + aoff[0]);
          ldmatrix_x4(a[1], row + aoff[1]);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int j = 0; j < kPass; ++j) {
              const int u = i - j;
              if (u < 0 || u >= kTaps) continue;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[j][nt], a[kk], bf[u][kk][nt]);
            }
        }
        // accumulator (row m, column n) -> epi[j][n][m]; columns 28.. dropped
        float* e = epi + (q & 1) * kEpiFloats;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int col = 8 * nt + 2 * tq + (k & 1);
              if (col < kEpiN)
                e[(j * kEpiN + col) * kEpiStride + 16 * warp + gq + 8 * (k >> 1)] =
                    acc[j][nt][k];
            }
      }
      // the last warp sums the previous pass while the others multiply
      if (warp == kMmaWarps && q > 0) epilogue(q - 1, lane, 32);
    }
    __syncthreads();
    epilogue(passes - 1, tid, kThreads);
    cp_async_wait<0>();
    __syncthreads();  // the ring and the epilogue buffers are free again
  }
}

}  // namespace

// xp: (n, h + 8, w + 8, 32) NHWC bf16, 16-byte aligned; w: (3, 32, 9, 9)
// bf16 read at strides (ws_o, ws_i, ws_u, ws_v) elements; b: (3,) bf16 or
// null; y: (n, h, w, 3) NHWC bf16 out. h, w >= 5; strip (output columns of
// a strip) 1 .. kStrip; rows (output rows a block runs through, in the
// (image, strip) columns taken in turn) >= 1. Launches on ``stream``;
// returns the CUDA error code (0 on success). Allocates nothing.
extern "C" int fnst_conv_to_rgb(const void* xp, const void* w, const void* b, void* y, int n,
                                int h, int wd, int strip, int rows, int ws_o, int ws_i,
                                int ws_u, int ws_v, void* stream) {
  if (n < 1 || h < 5 || wd < 5 || strip < 1 || strip > kStrip || rows < 1 ||
      (reinterpret_cast<uintptr_t>(xp) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  Geo g;
  g.h = h;
  g.w = wd;
  g.strip = strip;
  g.strips = (wd + strip - 1) / strip;
  g.total = (long long)n * g.strips * h;
  g.rows = rows;
  g.ws_o = ws_o;
  g.ws_i = ws_i;
  g.ws_u = ws_u;
  g.ws_v = ws_v;
  g.has_bias = b != nullptr;
  const long long blocks = (g.total + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_to_rgb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  conv_to_rgb_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const uint16_t*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), g);
  return cudaGetLastError();
}
