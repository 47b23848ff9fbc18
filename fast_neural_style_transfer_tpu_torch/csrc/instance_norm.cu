// Instance-norm forward and backward with the affine and an optional ReLU,
// for Hopper (sm_90a).
//
// Forward (fnst_instance_norm_fwd). Replaces the TPU kernel
// fast_neural_style_transfer_tpu/ops/pallas_norm.py::_in_fwd_kernel
// (launched by _pallas_in_forward). For each (sample n, channel c) of an
// NHWC activation x it computes the f32 mean and biased variance over H*W,
// inv = rsqrt(var + eps), y = x * (inv * gamma) + (beta - mean * inv *
// gamma), then an optional ReLU. y is written in x's dtype; mean and inv
// are written as (N, C) f32 residuals. The affine (gamma, beta) is one (C,)
// row for every sample, or an (N, C) row per sample (conditional instance
// norm: multi-style training conditions each example on its own style);
// every kernel reads sample s's row at gamma + s * gstride, gstride 0 or C.
// The per-sample rows add N * C * 8 bytes to a call that moves MBs. The
// statistics are "stable" by default, or one-pass on request: var =
// max(E[x^2] - mean^2, 0), the TPU kernel's own arithmetic.
//
// Bound: bytes. The work is ~8 flops per element against 2 bytes (bf16) or
// 4 bytes (f32) read and the same written, far below the card's ~295
// flops/byte balance point, so the least time is (read x once + write y
// once) over the 3.35 TB/s of HBM. One 256x256 stylizer forward has
// 13 * 1,048,576 + 2,097,152 = 15,728,640 IN elements: 62.9 MB of bf16
// traffic, 18.8 us at B=1 and 150 us at B=8 (f32 doubles both).
//
// Layout. A block owns a chunk of whole pixel rows of one sample: P pixels
// x all C channels, one contiguous byte range of NHWC x. It moves it in
// packs of 16 bytes (4 f32 or 8 bf16 channels of one pixel) where C *
// itemsize is a multiple of 16 and x is 16-byte aligned, else element by
// element (VEC = 1). Thread t of the block's 256 takes channel pack
// t % packs and pixel lane t / packs, so each warp moves one contiguous run
// of the chunk; a pixel row of more than 256 packs is taken 256 packs at a
// time. No element loop divides.
//
// Two kernels; the wrapper's planner (ops/cuda_norm.py::plan_fwd) picks one
// by shape and states the rule.
//
// One-launch kernel (in_fwd_resident), for a slab whose chunks all fit on
// the card at once (up to ~21 MB a sample on an H100): every IN site of the
// 256x256 serving and training paths. x crosses HBM once. Each block:
//   1. takes a ticket from a global counter (atomicAdd) and maps it to
//      (sample s, chunk j) = (ticket / chunks, ticket % chunks), not to
//      blockIdx: ticket order guarantees every lower ticket has started;
//   2. copies its chunk (at most 80 KB, so two blocks share an SM) into
//      dynamic shared memory with 16-byte cp.async, x's only read;
//   3. from shared memory, per channel: the chunk mean, then the sum of
//      squared deviations about it (one-pass: sum and sum of squares), the
//      lanes folded in a fixed tree; writes them to the workspace;
//   4. publishes them (__threadfence, atomicAdd on its sample's counter)
//      and waits until all G blocks of the sample have (ld.acquire.gpu,
//      __nanosleep back-off). Then it merges the chunk partials of its own
//      slice of ceil(C / G) channels (merge_chunks, in a fixed order, so
//      the result does not depend on arrival order and repeats bit for
//      bit), writes their mean, inv and (scale, shift), publishes on a
//      second counter and waits for all G slices (slice widths are
//      rounded up to a power of two). One block merging all C channels
//      would keep the others waiting while it reads G * C partials in a
//      chain of L2 round trips; split, each block reads G * ceil(C / G)
//      pairs at once;
//   5. reads every channel's (scale, shift) and writes y from its shared
//      copy with 16-byte stores.
// Why it cannot deadlock: a block waits only on blocks of its own sample.
// Tickets go out in order, one sample after another, so every sample but
// the newest has all its blocks started; none waits before it publishes,
// so each of its waits ends. Only the newest sample can have blocks that
// have not started. Older blocks finish and free their slots, and the next
// block to start takes the newest sample's next ticket; the newest
// sample's chunks G fit on the card together, because the wrapper routes
// here only where G <= capacity = blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the largest shared
// memory, kSmemLimit) x SMs, asked of the card once per device
// (fnst_instance_norm_fwd_capacity), and the launch refuses a larger G.
// This assumes no other kernel holds SM slots forever meanwhile. The
// counters (ticket, two per sample) are zeroed by cudaMemsetAsync on the
// same stream just before the kernel, in the same C call; nothing persists
// from one call to the next, so two streams never share counters, and a
// CUDA graph can capture the call.
//
// Two-launch kernel (in_fwd_partial, then in_fwd_apply), for any slab:
//   1. each thread sums d = v - K and d * d over its pixels, K the value
//      of the chunk's first pixel (one-pass: v and v * v); the block folds
//      its lanes and writes the chunk's (mean, M2) (one-pass: (sum, sum of
//      squares)) per channel to the workspace, then publishes on its
//      sample's counter; the sample's last block to publish merges all C
//      channels into mean, inv and (scale, shift). Nobody waits.
//   2. each block writes y for its chunk from a second read of x, with its
//      sample's (scale, shift).
// x crosses HBM twice where the slab does not fit the 50 MB L2.
//
// Capture and inject (video stylization with frozen IN statistics; the JAX
// package's TransformerNet.apply(return_stats=..., in_stats=...,
// stats_blend=...)). Capture: either kernel also writes each channel's f32
// variance (var), the exact value its merge hands to scale_shift. Inject
// (fnst_instance_norm_fwd_stats): normalize with reference moments instead
// of x's own, or with blend * ref + (1 - blend) * own. At blend 1 one
// launch (in_fwd_inject) computes each sample's (scale, shift) from the
// reference and applies it: no statistics pass, x read once and y written
// once, the same bytes bound as the plain forward. Below 1 the plain
// kernels run with the blend folded into their merge (one launch on the
// one-launch route, two on the two-launch route). The merge and the inject
// kernel share scale_shift, with every rounding pinned, and apply_chunk, so
// capture then inject at blend 1 gives the bits of the plain forward on
// the route the capture took. The two routes' statistics are summed in
// other orders, so their y may differ in the last bits from each other.
//
// Backward (fnst_instance_norm_bwd). Replaces the TPU kernel
// fast_neural_style_transfer_tpu/ops/pallas_norm.py::_in_bwd_kernel
// (launched by _pallas_in_backward, VJP _fused_in_bwd). From x, the upstream
// gradient g (already in x's dtype), the forward's (mean, inv) residuals and
// the affine (gamma, beta):
//   xhat = (x - mean) * inv;  with ReLU, g <- g * [xhat * gamma + beta > 0]
//   dx   = gamma * inv * (g - sum(g) / HW - xhat * sum(g * xhat) / HW)
//   per-sample dgamma = sum(g * xhat), dbeta = sum(g)  ((N, C) f32; for a
//   (C,) affine the wrapper sums them over N).
// gamma and beta are sample s's row, as in the forward (gstride 0 or C).
// The ReLU mask is rebuilt from x in f32 with every operation rounded on its
// own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), so it equals the
// plain PyTorch version's mask bit for bit on the same inputs. y is never
// saved: where the forward rounded y to bf16 next to 0, the mask may differ
// from relu(y) > 0, as it does in the TPU kernel.
// Bound: bytes. Read x and g once, write dx once: 3 * 2 B (bf16) per element,
// 15,728,640 IN elements per 256x256 image, so 1.89 GB and 0.56 ms at B=20
// bf16 over 3.35 TB/s (f32 doubles it). dx needs both sums over the whole
// sample first, so a design that reads x and g from device memory for the
// sums and again for dx moves five slab passes where the bound counts three.
//
// Two kernels, picked by the wrapper's planner (ops/cuda_norm.py::plan_bwd)
// by shape, as the forward's are.
//
// One-launch kernel (in_bwd_resident), for a slab whose chunks all fit on
// the card at once (x + g up to ~32 MB a sample on an H100): every IN site
// of the 256x256 training path. x and g cross HBM once. The forward's
// layout (16-byte packs of one pixel, Group, lane_sum) and hand-off. Each
// block:
//   1. takes a ticket (atomicAdd) and maps it to (sample s, chunk j) =
//      (ticket / chunks, ticket % chunks);
//   2. loads its chunk of x and the same pixels of g, the only read of
//      either: in f32 each thread's first 4 pixels into its registers
//      (bwd_reg_pixels), the rest into dynamic shared memory with 16-byte
//      cp.async (at most 96 KB of x and g, so two blocks share an SM), and
//      the sample's mean, inv and the affine beside them;
//   3. per channel: the chunk's gated sum(g) and sum(g * xhat) in f32, the
//      lanes folded in a fixed tree; writes the pair to the workspace and
//      keeps the gated g in place of g;
//   4. publishes it (red.release on its sample's counter) and waits until
//      all G blocks of the sample have (ld.acquire). Then it merges the
//      chunk partials of its own power-of-two slice of the channels
//      (sum_chunks, a fixed order), writes their per-sample dgamma and
//      dbeta and the coefficients a = sum(g) / HW and b = sum(g * xhat) /
//      HW, each value its own flag (st_published), and waits for every
//      channel's pair (ld_published);
//   5. writes dx from its registers and shared copies with 16-byte stores.
// What bounds it: a block holds its slot from its load to its store, and
// the card holds 264 blocks. They run in waves that load at once, then hand
// off while the memory idles (the sums, the wait for the sample's last
// block, two L2 round trips), then store. One block's load is no faster
// when few blocks load (TMA bulk copies are no faster either), so one
// sample's loads cannot be run alone ahead of the next sample's; what moves
// the time is the bytes a wave holds. So the planner fills a wave with
// whole samples (a sample split over two waves keeps its first blocks
// waiting through a wave), and f32 keeps part of the chunk in registers,
// which lets a wave hold 4 samples of 64x64x256 (not 3) and 2 of
// 256x256x32 (not 1). bf16 holds none: there its sums and dx take twice the
// instructions a byte, and it ran slower with any.
// Why it cannot deadlock: the forward's argument, with this kernel's own
// capacity. A block waits only on blocks of its own sample; tickets go out
// sample by sample, so only the newest sample can have blocks that have not
// started, and its G chunks fit on the card together: the wrapper routes
// here only where G <= blocks per SM of in_bwd_resident at its largest
// shared memory (kSmemLimit) x SMs, asked of the card once per device
// (fnst_instance_norm_bwd_capacity), and the launch refuses a larger G.
// The counters and the coefficients' flags are zeroed by cudaMemsetAsync on
// the same stream in the same C call, so a CUDA graph can capture the call.
//
// Two-launch kernel, for any slab: two launches over chunks of H*W.
//   1. in_bwd_partial: a block owns (sample, pixel chunk, tile of <= 32
//      channels); each thread sums the gated g and g * xhat over its pixels
//      in f32, the block adds its 8 pixel lanes and writes one partial pair
//      per (n, chunk, c) to an f32 workspace (2, N, chunks, C).
//   2. in_bwd_apply: every block adds its channels' chunk partials, the
//      first chunk's block writes the per-sample dgamma / dbeta, and each
//      block writes dx for its own chunk from a second read of x and g.
//
// Sharded forms (one image's rows split over ranks, ops/sharded.py; the JAX
// package's instance_norm_sharded, plain jnp with two psums). The wrapper
// (ops/cuda_norm.py::ShardedInstanceNormFn) puts a cross-rank all_reduce
// between a statistics pass and an apply pass:
//   forward: the statistics-only route (y null): either forward kernel with
//     no y, the one-launch kernel ending with its merge (step 4), the
//     two-launch kernel with in_fwd_partial alone; x is read once and each
//     (sample, channel)'s (mean, var) of this rank's rows written. The
//     wrapper merges the ranks' (count, mean, M2) (Chan's formula, f64, rank
//     order), then in_fwd_inject normalizes with the global moments. Bound:
//     1.5x the unsharded forward's bytes: x read twice, y written once.
//     sstride (pixels from one sample's first pixel to the next's, >= hw)
//     lets both passes cover a prefix of each sample's rows (the extent mask
//     of an unaligned height) where they lie: a copy of the active rows
//     would read and write the slab once more.
//   backward: fnst_instance_norm_bwd_sums (in_bwd_partial, then
//     in_bwd_sum_chunks adds the chunk partials in order) gives this rank's
//     gated sum(g) and sum(g * xhat); the wrapper sums them over the ranks,
//     and fnst_instance_norm_bwd_apply (in_bwd_apply with the sums given)
//     writes dx. Bound: read x and g twice, write dx once (5 slab passes
//     against the unsharded bound's 3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a block (but the two-launch backward)
constexpr int kTileC = 32;     // two-launch backward: channels per block
constexpr int kLanes = 8;      // two-launch backward: pixel lanes per block

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

// One pack: VEC channels of one pixel, moved as one 16-byte access (VEC > 1)
// or as one element (VEC == 1).
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float (&f)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a pack is 16 bytes");
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
}

// The pack is read as one access into a register first: unpacking it where
// it lies would read element by element.
template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* p, float (&f)[VEC]) {
  const Raw<T, VEC> r = *reinterpret_cast<const Raw<T, VEC>*>(p);
  unpack<T, VEC>(r, f);
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&f)[VEC]) {
  Raw<T, VEC> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(f[i]);
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float (&f)[VEC]) {
  *reinterpret_cast<Raw<T, VEC>*>(p) = pack<T, VEC>(f);
}

// The block over the channel packs [cv0, cv0 + packs) of a pixel row:
// thread t takes pack cv0 + t % packs and pixel lane t / packs; threads
// with lane >= lanes (when packs does not divide the block) sit out.
struct Group {
  int width;  // channels of the group: packs * VEC
  int lanes;  // pixel lanes
  int lane;   // this thread's lane
  int ch;     // this thread's first channel
};

template <int VEC>
__device__ __forceinline__ Group group(int c, int cv0) {
  const int packs = min(c / VEC - cv0, kThreads);
  Group g;
  g.width = packs * VEC;
  g.lanes = kThreads / packs;
  g.lane = threadIdx.x / packs;
  g.ch = (cv0 + threadIdx.x % packs) * VEC;
  return g;
}

// Adds red[l * width + k] over the lanes l < lanes into red[k], for each
// channel k < width of the group, by a fixed tree: lanes [half, lanes) onto
// [0, lanes - half), half = ceil(lanes / 2), until one lane is left. The
// same for `arrays` arrays `stride` floats apart. Begins and ends with a
// barrier; the same order every call, so the sums repeat bit for bit.
__device__ __forceinline__ void fold_lanes(float* red, int lanes, int width,
                                           int arrays, int stride) {
  while (lanes > 1) {
    const int half = (lanes + 1) / 2;
    const int m = (lanes - half) * width;
    __syncthreads();
    for (int a = 0; a < arrays; ++a) {
      float* r = red + a * stride;
      for (int i = threadIdx.x; i < m; i += kThreads) r[i] += r[i + half * width];
    }
    lanes = half;
  }
  __syncthreads();
}

// Sums each thread's values a[n][0..VEC) over the lanes of its slot into
// red + n * kThreads * VEC, at [slot * VEC + i]: thread t holds VEC
// channels of slot t % slots (slots <= 256) in lane t / slots; threads
// past the last whole lane hold zeros. A fixed tree: where
// slots is a power of two below 32, first inside each warp by xor shuffles,
// the farthest lanes first, then the 8 warps' sums as fold_lanes; else
// fold_lanes over all the lanes. Ends with a barrier. Every call adds in
// the same order, so the sums repeat bit for bit.
template <int VEC, int NA>
__device__ __forceinline__ void lane_sum(float* red, float (&a)[NA][VEC],
                                         int slots) {
  const int width = slots * VEC;
  int lanes = kThreads / slots;
  int lane = threadIdx.x / slots;
  const int slot = threadIdx.x % slots;
  if (slots < 32 && (slots & (slots - 1)) == 0) {
    for (int o = 16; o >= slots; o >>= 1) {
#pragma unroll
      for (int n = 0; n < NA; ++n) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a[n][i] += __shfl_xor_sync(0xffffffffu, a[n][i], o);
        }
      }
    }
    lanes = kThreads / 32;
    lane = threadIdx.x % 32 < slots ? threadIdx.x / 32 : -1;
  }
  if (lane >= 0) {
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      float* r = red + n * kThreads * VEC + lane * width + slot * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          *reinterpret_cast<float4*>(r + i) =
              make_float4(a[n][i], a[n][i + 1], a[n][i + 2], a[n][i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) r[i] = a[n][i];
      }
    }
  }
  fold_lanes(red, lanes, width, NA, kThreads * VEC);
}

// The one-launch block's largest dynamic shared memory: two blocks fit an
// SM's 228 KB.
constexpr int kSmemLimit = 112 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

// Thread 0, after a barrier that follows the block's writes: adds one to
// *count with release semantics, which orders those writes before it (the
// barrier makes them the thread's own for the release), without waiting.
__device__ __forceinline__ void publish(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u)
               : "memory");
}

// Thread 0: waits until *count reaches target (acquire loads, __nanosleep
// back-off); then what every publisher wrote before publishing is visible
// to the block after its next barrier.
__device__ __forceinline__ void wait_count(const unsigned* count,
                                           unsigned target) {
  unsigned ns = 32;
  while (ld_acquire(count) < target) {
    __nanosleep(ns);
    ns = ns < 256u ? 2 * ns : ns;
  }
}

// Floats of the one-launch block's lane sums (merge_chunks needs 2 * kThreads).
template <int VEC>
__host__ __device__ constexpr int red_floats() {
  return kThreads * (VEC > 2 ? VEC : 2);
}

// The one-launch block's dynamic shared memory: its chunk (rounded up to 16
// bytes), the lane sums, and each channel's (scale, shift). ops/cuda_norm.py::
// fwd_smem_bytes is the same formula.
__host__ __device__ inline size_t chunk_smem_bytes(int chunk, int c,
                                                   int itemsize) {
  return ((size_t)chunk * c * itemsize + 15) / 16 * 16;
}

template <typename T, int VEC>
size_t resident_smem(int chunk, int c) {
  return chunk_smem_bytes(chunk, c, sizeof(T)) +
         sizeof(float) * (red_floats<VEC>() + 2 * (size_t)c);
}

// One lane's sums of one channel's chunk partials a_j = part_s[j][0][ch],
// b_j = part_s[j][1][ch] of part_s (chunks, 2, c), over its chunks j =
// lane, lane + lanes, ... in order, kBatch chunks' loads in flight at once
// (lanes >= 1; a lane >= lanes adds nothing). Plain sums of a_j and b_j,
// or (kShifted, chunk statistics (mean_j, M2_j)) sums about K = mean_0 of
// n_j d and M2_j + n_j d^2, d = mean_j - K, n_j the chunk's pixels.
template <bool kShifted>
__device__ __forceinline__ void sum_chunks(const float* part_s, int c, int ch,
                                           int lane, int lanes, int chunks,
                                           int chunk, int hw, float k,
                                           float& s1, float& s2) {
  constexpr int kBatch = 8;
  s1 = s2 = 0.f;
  for (int j0 = lane; lane < lanes && j0 < chunks; j0 += kBatch * lanes) {
    float a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * lanes;
      a[u] = j < chunks ? __ldcg(part_s + (size_t)j * 2 * c + ch) : 0.f;
      b[u] = j < chunks ? __ldcg(part_s + (size_t)j * 2 * c + c + ch) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * lanes;
      if (j >= chunks) break;
      if (kShifted) {
        const float nj = (float)min(chunk, hw - j * chunk);
        const float d = a[u] - k;
        s1 = fmaf(nj, d, s1);
        s2 += fmaf(nj * d, d, b[u]);
      } else {
        s1 += a[u];
        s2 += b[u];
      }
    }
  }
}

// One channel's inv = rsqrt(var + eps), scale = inv * gamma and shift =
// beta - mean * scale, every operation rounded as written (the shift as one
// fused multiply-add). Every path that normalizes calls it: the statistics
// kernels' merge and the inject kernel, so that normalizing with captured
// (mean, var) gives the plain forward's bits (nvcc may otherwise contract
// the shift differently in two kernels).
__device__ __forceinline__ void scale_shift(float mean, float var, float eps,
                                            float gamma, float beta,
                                            float& inv, float& scale,
                                            float& shift) {
  inv = rsqrtf(__fadd_rn(var, eps));
  scale = __fmul_rn(inv, gamma);
  shift = __fmaf_rn(-mean, scale, beta);
}

// The capture and inject modes of the forward (video: frozen statistics).
// var: (n, c) f32 out, each channel's own biased variance, the exact value
// scale_shift receives, or nullptr. ref_mean, ref_var: reference moments,
// sample s's row at s * rstride (rstride 0: one (c,) row for all, or c), or
// nullptr; with them the kernel normalizes with blend * ref + keep * own
// (keep = 1 - blend, given by the caller) in place of its own moments.
struct StatsIO {
  float* var;
  const float* ref_mean;
  const float* ref_var;
  int rstride;
  float blend, keep;
};

// blend * r + keep * v, each product rounded, then the sum.
__device__ __forceinline__ float blend_moment(float r, float v, float blend,
                                              float keep) {
  return __fadd_rn(__fmul_rn(blend, r), __fmul_rn(keep, v));
}

// Merges one sample's chunk partials part_s (chunks, 2, c) for the channels
// [c0, c1) and writes their mean, inv, scale (ss_s[ch]) and shift
// (ss_s[c + ch]), with the sample's affine row gamma_s, beta_s, and (io) its
// var, or blends its moments with reference ones first (mean_s and var
// keep the sample's own moments). Thread t takes channel t % width of a
// group of at most 256 and chunk lane t / width; a lane sums its chunks
// (sum_chunks: about chunk 0's mean; one-pass: plain sums), and the lanes
// fold in a fixed tree. red holds 2 * kThreads floats.
template <bool kOnePass>
__device__ __forceinline__ void merge_chunks(
    const float* part_s, float* red, int c0, int c1, int c, int hw, int chunk,
    int chunks, float eps, const float* __restrict__ gamma_s,
    const float* __restrict__ beta_s, float* mean_s, float* inv_s, float* ss_s,
    StatsIO io, int s) {
  for (int g0 = c0; g0 < c1; g0 += kThreads) {
    const int width = min(c1 - g0, kThreads);
    const int lanes = kThreads / width;
    const int lane = threadIdx.x / width;
    const int ch = g0 + threadIdx.x % width;
    // every load of the group goes out before the first is used
    const float ga = gamma_s[ch];
    const float be = beta_s[ch];
    const float k = kOnePass ? 0.f : __ldcg(part_s + ch);
    float s1, s2;
    sum_chunks<!kOnePass>(part_s, c, ch, lane, lanes, chunks, chunk, hw, k, s1,
                          s2);
    float sums[2][1] = {{s1}, {s2}};
    lane_sum<1, 2>(red, sums, width);
    if (threadIdx.x < width) {
      s1 = red[threadIdx.x];
      s2 = red[kThreads + threadIdx.x];
      const float fhw = (float)hw;
      float mean, var;
      if (kOnePass) {
        mean = s1 / fhw;
        var = fmaxf(s2 / fhw - mean * mean, 0.f);
      } else {
        const float dm = s1 / fhw;
        mean = k + dm;
        var = fmaxf(s2 - s1 * dm, 0.f) / fhw;
      }
      mean_s[ch] = mean;
      if (io.var) io.var[(size_t)s * c + ch] = var;
      if (io.ref_mean) {
        const size_t r = (size_t)s * io.rstride + ch;
        mean = blend_moment(io.ref_mean[r], mean, io.blend, io.keep);
        var = blend_moment(io.ref_var[r], var, io.blend, io.keep);
      }
      float inv, scale, shift;
      scale_shift(mean, var, eps, ga, be, inv, scale, shift);
      inv_s[ch] = inv;
      ss_s[ch] = scale;
      ss_s[c + ch] = shift;
    }
    __syncthreads();
  }
}

// y = x * scale + shift (then the ReLU) over one chunk of np pixels, from
// src (x in device memory, or the block's copy in shared memory) to dst;
// cst holds each channel's scale, then each channel's shift.
template <typename T, int VEC>
__device__ __forceinline__ void apply_chunk(const T* src, T* __restrict__ dst,
                                            int np, int c, const float* cst,
                                            int relu) {
  for (int cv0 = 0; cv0 < c / VEC; cv0 += kThreads) {
    const Group g = group<VEC>(c, cv0);
    if (g.lane >= g.lanes) continue;
    float sc[VEC], sh[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[i] = cst[g.ch + i];
      sh[i] = cst[c + g.ch + i];
    }
#pragma unroll 4
    for (int p = g.lane; p < np; p += g.lanes) {
      const size_t o = (size_t)p * c + g.ch;
      float v[VEC];
      load_pack<T, VEC>(src + o, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[i] = fmaf(v[i], sc[i], sh[i]);
        if (relu) v[i] = fmaxf(v[i], 0.f);
      }
      store_pack<T, VEC>(dst + o, v);
    }
  }
}

// Launch 1 of the two-launch kernel: block (chunk j, sample s) writes the
// chunk's per-channel (mean, M2), one-pass (sum, sum of squares), to
// part[s][j][0 | 1][c]. Sums are shifted by K, the chunk's first pixel, so
// that M2 = S2 - S1^2 / n loses nothing to cancellation near the mean. The
// sample's last block to publish merges all its partials into mean, inv
// and ss[s] = (scale, shift). At most 51 registers a thread (65,536 / (5 *
// 256)), so that five blocks fit an SM: the planner's grid of about four
// blocks per SM rounds up past four (540 blocks at the B=20 training
// shapes), and at four an SM (63 registers) the f32 kernel ran 14 %
// slower.
template <typename T, int VEC, bool kOnePass>
__global__ void __launch_bounds__(kThreads, 5)
    in_fwd_partial(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ mean_out,
                   float* __restrict__ inv_out, float* __restrict__ part,
                   float* __restrict__ ss, unsigned* __restrict__ counters,
                   int hw, int sstride, int c, int gstride, int chunk,
                   int chunks, float eps, StatsIO io) {
  // two lane-sum arrays, which merge_chunks takes as one of 2 * kThreads
  __shared__ __align__(16) float red[2 * kThreads * VEC];
  __shared__ int s_last;
  const int s = blockIdx.y;
  const int j = blockIdx.x;
  const int p0 = j * chunk;
  const int np = min(chunk, hw - p0);
  const T* xc = x + ((size_t)s * sstride + p0) * c;
  float* pm = part + ((size_t)s * chunks + j) * 2 * c;
  for (int cv0 = 0; cv0 < c / VEC; cv0 += kThreads) {
    const Group g = group<VEC>(c, cv0);
    float k[VEC], ab[2][VEC];  // sums of d and of d * d
#pragma unroll
    for (int i = 0; i < VEC; ++i) k[i] = ab[0][i] = ab[1][i] = 0.f;
    if (g.lane < g.lanes) {
      if (!kOnePass) load_pack<T, VEC>(xc + g.ch, k);
#pragma unroll 4
      for (int p = g.lane; p < np; p += g.lanes) {
        float v[VEC];
        load_pack<T, VEC>(xc + (size_t)p * c + g.ch, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - k[i];
          ab[0][i] += d;
          ab[1][i] = fmaf(d, d, ab[1][i]);
        }
      }
    }
    lane_sum<VEC, 2>(red, ab, g.width / VEC);
    for (int kk = threadIdx.x; kk < g.width; kk += kThreads) {
      const float s1 = red[kk];
      const float s2 = red[kThreads * VEC + kk];
      const int ch = cv0 * VEC + kk;
      if (kOnePass) {
        pm[ch] = s1;
        pm[c + ch] = s2;
      } else {
        const float dm = s1 / (float)np;
        pm[ch] = to_f32(xc[ch]) + dm;
        pm[c + ch] = fmaxf(s2 - s1 * dm, 0.f);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counters + 1 + s, 1u) == (unsigned)(chunks - 1);
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (s_last) {
    merge_chunks<kOnePass>(part + (size_t)s * chunks * 2 * c, red, 0, c, c, hw,
                           chunk, chunks, eps, gamma + (size_t)s * gstride,
                           beta + (size_t)s * gstride, mean_out + (size_t)s * c,
                           inv_out + (size_t)s * c, ss + (size_t)s * 2 * c, io,
                           s);
  }
}

// Launch 2 of the two-launch kernel: block (chunk j, sample s).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_fwd_apply(const T* __restrict__ x, const float* __restrict__ ss,
                 T* __restrict__ y, int hw, int sstride, int c, int chunk,
                 int relu) {
  const int s = blockIdx.y;
  const int p0 = blockIdx.x * chunk;
  const size_t off = ((size_t)s * sstride + p0) * c;
  apply_chunk<T, VEC>(x + off, y + off, min(chunk, hw - p0), c,
                      ss + (size_t)s * 2 * c, relu);
}

// The inject mode at blend 1 (frozen statistics): block (chunk j, sample s)
// computes every channel's (scale, shift) from the reference moments of its
// sample (scale_shift, as the statistics kernels do) into shared memory,
// then writes y for its chunk (apply_chunk, as in_fwd_apply does). No
// statistics pass: x is read once and y written once, in one launch. Each
// block recomputes the C pairs (C <= 512 here), against the chunk's MB.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    in_fwd_inject(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ inv_out, int hw, int sstride, int c,
                  int gstride, int chunk, float eps, int relu, StatsIO io) {
  extern __shared__ __align__(16) float inject_cst[];  // scale (c), shift (c)
  const int s = blockIdx.y;
  const int p0 = blockIdx.x * chunk;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const size_t r = (size_t)s * io.rstride + ch;
    const size_t a = (size_t)s * gstride + ch;
    float inv, scale, shift;
    scale_shift(io.ref_mean[r], io.ref_var[r], eps, gamma[a], beta[a], inv,
                scale, shift);
    if (blockIdx.x == 0) inv_out[(size_t)s * c + ch] = inv;
    inject_cst[ch] = scale;
    inject_cst[c + ch] = shift;
  }
  __syncthreads();
  const size_t off = ((size_t)s * sstride + p0) * c;
  apply_chunk<T, VEC>(x + off, y + off, min(chunk, hw - p0), c, inject_cst,
                      relu);
}

// The one-launch kernel (steps 1-5 in the header). part: (n, chunks, 2, c)
// chunk partials; ss: (n, 2, c) each sample's (scale, shift); counters:
// [ticket, published (n), merged (n)], zero at launch. At most 128
// registers a thread, so that two blocks fit an SM.
template <typename T, int VEC, bool kOnePass>
__global__ void __launch_bounds__(kThreads, 2)
    in_fwd_resident(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ inv_out,
                    float* __restrict__ part, float* __restrict__ ss,
                    unsigned* __restrict__ counters, int n, int hw,
                    int sstride, int c, int gstride, int chunk, int chunks,
                    float eps, int relu, StatsIO io) {
  extern __shared__ __align__(16) unsigned char resident_smem_raw[];
  T* xs = reinterpret_cast<T*>(resident_smem_raw);
  float* red = reinterpret_cast<float*>(
      resident_smem_raw + chunk_smem_bytes(chunk, c, sizeof(T)));
  float* cst = red + red_floats<VEC>();
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x;

  // 1. ticket -> (sample, chunk)
  if (tid == 0) s_ticket = atomicAdd(counters, 1u);
  __syncthreads();
  const int s = (int)(s_ticket / (unsigned)chunks);
  const int j = (int)(s_ticket % (unsigned)chunks);
  const int p0 = j * chunk;
  const int np = min(chunk, hw - p0);
  const size_t off = ((size_t)s * sstride + p0) * c;

  // 2. the chunk into shared memory
  if constexpr (VEC > 1) {
    for (int i = tid * VEC; i < np * c; i += kThreads * VEC) {
      cp_async16(xs + i, x + off + i);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    for (int i = tid; i < np * c; i += kThreads) xs[i] = x[off + i];
  }
  __syncthreads();

  // 3. the chunk's statistics
  float* pm = part + ((size_t)s * chunks + j) * 2 * c;
  for (int cv0 = 0; cv0 < c / VEC; cv0 += kThreads) {
    const Group g = group<VEC>(c, cv0);
    const int base = cv0 * VEC;
    float a[1][VEC], b[1][VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[0][i] = b[0][i] = 0.f;
    if (g.lane < g.lanes) {
#pragma unroll 4
      for (int p = g.lane; p < np; p += g.lanes) {
        float v[VEC];
        load_pack<T, VEC>(xs + p * c + g.ch, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a[0][i] += v[i];
          if (kOnePass) b[0][i] = fmaf(v[i], v[i], b[0][i]);
        }
      }
    }
    lane_sum<VEC, 1>(red, a, g.width / VEC);
    for (int kk = tid; kk < g.width; kk += kThreads) {
      const float v = kOnePass ? red[kk] : red[kk] / (float)np;
      pm[base + kk] = v;
      cst[base + kk] = v;
    }
    __syncthreads();
    if (!kOnePass && g.lane < g.lanes) {
      float m[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = cst[g.ch + i];
#pragma unroll 4
      for (int p = g.lane; p < np; p += g.lanes) {
        float v[VEC];
        load_pack<T, VEC>(xs + p * c + g.ch, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - m[i];
          b[0][i] = fmaf(d, d, b[0][i]);
        }
      }
    }
    lane_sum<VEC, 1>(red, b, g.width / VEC);
    for (int kk = tid; kk < g.width; kk += kThreads) pm[c + base + kk] = red[kk];
    __syncthreads();
  }

  // 4. hand-off within the sample: wait until every block has published,
  // merge this block's slice of the channels, wait until every slice is in
  float* ss_s = ss + (size_t)s * 2 * c;
  if (tid == 0) {
    unsigned* published = counters + 1 + s;
    publish(published);
    wait_count(published, (unsigned)chunks);
  }
  __syncthreads();
  // slices of a power-of-two width, for lane_sum's shuffles
  int per = 1;
  while (per * chunks < c) per *= 2;
  const int c0 = min(c, j * per);
  merge_chunks<kOnePass>(part + (size_t)s * chunks * 2 * c, red, c0,
                         min(c, c0 + per), c, hw, chunk, chunks, eps,
                         gamma + (size_t)s * gstride,
                         beta + (size_t)s * gstride, mean_out + (size_t)s * c,
                         inv_out + (size_t)s * c, ss_s, io, s);
  // the statistics-only route ends with the merge: no y
  if (y == nullptr) return;
  __syncthreads();
  if (tid == 0) {
    unsigned* merged = counters + 1 + n + s;
    publish(merged);
    wait_count(merged, (unsigned)chunks);
  }
  __syncthreads();
  for (int k = tid; k < 2 * c; k += kThreads) cst[k] = __ldcg(ss_s + k);
  __syncthreads();

  // 5. y from the shared copy
  apply_chunk<T, VEC>(xs, y + off, np, c, cst, relu);
}

// The arguments of one forward call.
struct FwdArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* mean;
  float* inv;
  float* work;
  unsigned* counters;
  int n, hw, sstride, c, gstride, chunk, chunks;
  float eps;
  int relu, onepass, is_bf16, vec, resident;
  cudaStream_t stream;
  StatsIO io;       // capture and inject (all null: the plain forward)
  int inject_only;  // in_fwd_inject: the reference moments alone (blend 1)
};

// The first `count` counters to 0, on the kernel's stream (FwdArgs or
// BwdArgs).
template <typename Args>
cudaError_t zero_counters(const Args& a, size_t count) {
  return cudaMemsetAsync(a.counters, 0, count * sizeof(unsigned), a.stream);
}

template <typename T, int VEC, bool kOnePass>
cudaError_t launch_two(const FwdArgs& a) {
  const dim3 grid(a.chunks, a.n);
  const T* x = static_cast<const T*>(a.x);
  float* ss = a.work + (size_t)a.n * a.chunks * 2 * a.c;
  cudaError_t err = zero_counters(a, 1 + 2 * (size_t)a.n);
  if (err != cudaSuccess) return err;
  in_fwd_partial<T, VEC, kOnePass><<<grid, kThreads, 0, a.stream>>>(
          x, a.gamma, a.beta, a.mean, a.inv, a.work, ss, a.counters, a.hw,
          a.sstride, a.c, a.gstride, a.chunk, a.chunks, a.eps, a.io);
  err = cudaGetLastError();
  // the statistics-only route: launch 1 alone
  if (err != cudaSuccess || a.y == nullptr) return err;
  in_fwd_apply<T, VEC><<<grid, kThreads, 0, a.stream>>>(
      x, ss, static_cast<T*>(a.y), a.hw, a.sstride, a.c, a.chunk, a.relu);
  return cudaGetLastError();
}

// One one-launch kernel's capacity per device: blocks per SM + 1 (0: not
// asked yet), SMs.
struct CapacityCache {
  std::mutex lock;
  int cached[kMaxDevices][2];
};

// Blocks of `kernel` (a one-launch kernel of kThreads threads) the current
// device holds at once at kSmemLimit bytes of shared memory: (blocks per
// SM, SMs), asked of the card once per device (which also raises the
// kernel's shared-memory limit there) and kept in `cache`.
template <typename Kernel>
cudaError_t capacity_of(Kernel kernel, CapacityCache& cache, int* per_sm,
                        int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto& cached = cache.cached;
  std::lock_guard<std::mutex> guard(cache.lock);
  if (cached[dev][0] == 0) {
    int blocks = 0, count = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, kSmemLimit);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    cached[dev][0] = blocks + 1;
    cached[dev][1] = count;
  }
  *per_sm = cached[dev][0] - 1;
  *sms = cached[dev][1];
  return cudaSuccess;
}

template <typename T, int VEC, bool kOnePass>
cudaError_t resident_capacity(int* per_sm, int* sms) {
  static CapacityCache cache;
  return capacity_of(in_fwd_resident<T, VEC, kOnePass>, cache, per_sm, sms);
}

template <typename T, int VEC, bool kOnePass>
cudaError_t launch_resident(const FwdArgs& a) {
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_capacity<T, VEC, kOnePass>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = resident_smem<T, VEC>(a.chunk, a.c);
  // a larger G could wait forever for a block that never starts
  if (smem > (size_t)kSmemLimit || a.chunks > per_sm * sms) {
    return cudaErrorInvalidValue;
  }
  err = zero_counters(a, 1 + 2 * (size_t)a.n);
  if (err != cudaSuccess) return err;
  float* ss = a.work + (size_t)a.n * a.chunks * 2 * a.c;
  in_fwd_resident<T, VEC, kOnePass>
      <<<a.n * a.chunks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.gamma, a.beta, static_cast<T*>(a.y), a.mean,
      a.inv, a.work, ss, a.counters, a.n, a.hw, a.sstride, a.c, a.gstride,
      a.chunk, a.chunks, a.eps, a.relu, a.io);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_inject(const FwdArgs& a) {
  const dim3 grid(a.chunks, a.n);
  in_fwd_inject<T, VEC><<<grid, kThreads, 2 * sizeof(float) * a.c, a.stream>>>(
      static_cast<const T*>(a.x), a.gamma, a.beta, static_cast<T*>(a.y), a.inv,
      a.hw, a.sstride, a.c, a.gstride, a.chunk, a.eps, a.relu, a.io);
  return cudaGetLastError();
}

template <typename T, int VEC, bool kOnePass>
struct FwdOp {
  static cudaError_t run(const FwdArgs& a) {
    if (a.inject_only) return launch_inject<T, VEC>(a);
    return a.resident ? launch_resident<T, VEC, kOnePass>(a)
                      : launch_two<T, VEC, kOnePass>(a);
  }
};

template <typename T, int VEC, bool kOnePass>
struct CapacityOp {
  static cudaError_t run(int* per_sm, int* sms) {
    return resident_capacity<T, VEC, kOnePass>(per_sm, sms);
  }
};

// Op<T, VEC, kOnePass>::run(args...) for the variant named at run time:
// f32 or bf16, 16-byte packs or single elements, stable or one-pass.
template <template <typename, int, bool> class Op, typename T, typename... Args>
cudaError_t dispatch_type(int vec, int onepass, Args... args) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return onepass ? Op<T, kVec, true>::run(args...)
                   : Op<T, kVec, false>::run(args...);
  }
  if (vec == 1) {
    return onepass ? Op<T, 1, true>::run(args...) : Op<T, 1, false>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int, bool> class Op, typename... Args>
cudaError_t dispatch(int is_bf16, int vec, int onepass, Args... args) {
  return is_bf16 ? dispatch_type<Op, __nv_bfloat16>(vec, onepass, args...)
                 : dispatch_type<Op, float>(vec, onepass, args...);
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
                   int n, int hw, int c, int gstride, int chunk, int chunks,
                   int relu) {
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
    const float ga = gamma[(size_t)s * gstride + ch];
    const float be = beta[(size_t)s * gstride + ch];
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

// The sharded backward's local sums (launch 2 of fnst_instance_norm_bwd_sums):
// adds in_bwd_partial's chunk partials (2, n, chunks, c) in chunk order into
// sums (2, n, c), sum(g) then sum(g * xhat) of each (sample, channel) over
// this rank's pixels. One thread a (sample, channel).
__global__ void __launch_bounds__(kThreads)
    in_bwd_sum_chunks(const float* __restrict__ work, float* __restrict__ sums,
                      int n, int c, int chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * c) return;
  const int s = i / c;
  const int ch = i % c;
  const size_t plane = (size_t)n * chunks * c;
  float sg = 0.f, sgx = 0.f;
  for (int j = 0; j < chunks; ++j) {
    const size_t slot = ((size_t)s * chunks + j) * c + ch;
    sg += work[slot];
    sgx += work[plane + slot];
  }
  sums[i] = sg;
  sums[(size_t)n * c + i] = sgx;
}

// Launch 2 of the two-launch backward. kGiven (the sharded backward's apply):
// work holds the caller's sums (2, n, c), sum(g) then sum(g * xhat) over
// every rank's pixels, `count` pixels in all; dgamma and dbeta are not
// written. Otherwise work holds in_bwd_partial's chunk partials and count is
// hw.
template <typename T, bool kGiven>
__global__ void __launch_bounds__(kTileC * kLanes)
    in_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ work, T* __restrict__ dx,
                 float* __restrict__ dgamma, float* __restrict__ dbeta, int n,
                 int hw, int c, int gstride, int chunk, int chunks, int relu,
                 float count) {
  const int cx = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kTileC + cx;
  const int s = blockIdx.z;

  // each pixel lane adds every kLanes-th chunk partial, then lane 0 the lanes
  float sg = 0.f, sgx = 0.f;
  if (!kGiven && ch < c) {
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
    if (kGiven) {
      s_a[cx] = work[(size_t)s * c + ch] / count;
      s_b[cx] = work[((size_t)n + s) * c + ch] / count;
    } else {
      for (int l = 1; l < kLanes; ++l) {
        sg += sh[0][l][cx];
        sgx += sh[1][l][cx];
      }
      s_a[cx] = sg / count;
      s_b[cx] = sgx / count;
      if (blockIdx.x == 0) {
        dgamma[(size_t)s * c + ch] = sgx;
        dbeta[(size_t)s * c + ch] = sg;
      }
    }
  }
  __syncthreads();
  if (ch >= c) return;

  const float m = mean[(size_t)s * c + ch];
  const float iv = inv[(size_t)s * c + ch];
  const float ga = gamma[(size_t)s * gstride + ch];
  const float be = beta[(size_t)s * gstride + ch];
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

// The one-launch backward block's per-channel constants in shared memory:
// mean, inv, gamma, beta of its sample (its own affine row), then a and b
// (after the hand-off), c floats each.
constexpr int kBwdConsts = 6;

// Floats of the one-launch backward block's lane sums: two arrays of
// kThreads packs (sum_chunks' merge needs 2 * kThreads).
template <int VEC>
__host__ __device__ constexpr int bwd_red_floats() {
  return 2 * kThreads * VEC;
}

// Packs of x and of g a one-launch backward thread holds in registers
// through the hand-off, within 128 registers: 4 in f32; none in bf16, whose
// kernel is slower with any (its sums and dx take twice the instructions a
// byte, and the registers they need).
template <int VEC>
__host__ __device__ constexpr int bwd_reg_packs() {
  return VEC == 8 ? 0 : 4;
}

// The first pixels of a one-launch backward block's chunk, which its
// threads hold in registers: bwd_reg_packs pixels a lane, where a pixel row
// is one group of packs (no more packs than threads); the rest of the chunk
// sits in shared memory.
template <int VEC>
__host__ __device__ inline int bwd_reg_pixels(int c) {
  const int packs = c / VEC;
  return packs <= kThreads ? bwd_reg_packs<VEC>() * (kThreads / packs) : 0;
}

// The one-launch backward block's dynamic shared memory: the shared part of
// its chunk of x and of g (each rounded up to 16 bytes), the lane sums and
// the per-channel constants. ops/cuda_norm.py::bwd_smem_bytes is the same
// formula.
template <typename T, int VEC>
size_t bwd_resident_smem(int chunk, int c) {
  const int shared = chunk > bwd_reg_pixels<VEC>(c) ? chunk - bwd_reg_pixels<VEC>(c) : 0;
  return 2 * chunk_smem_bytes(shared, c, sizeof(T)) +
         sizeof(float) * (bwd_red_floats<VEC>() + kBwdConsts * (size_t)c);
}

// Stores v at p for other blocks that wait for it (ld_published): as the
// bits of v inverted, in a buffer zeroed at launch, so that 0 reads as "not
// yet stored". A NaN is stored as the canonical one, whose inverted bits are
// not 0. The value is its own flag: no fence orders other writes before it.
__device__ __forceinline__ void st_published(unsigned* p, float v) {
  const unsigned w = ~__float_as_uint(v != v ? __int_as_float(0x7fffffff) : v);
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(w) : "memory");
}

// Waits (__nanosleep back-off) until another block has stored a value at p
// with st_published, and returns it.
__device__ __forceinline__ float ld_published(const unsigned* p) {
  unsigned w, ns = 32;
  while (true) {
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(w) : "l"(p) : "memory");
    if (w != 0u) break;
    __nanosleep(ns);
    ns = ns < 256u ? 2 * ns : ns;
  }
  return __uint_as_float(~w);
}

// Merges one sample's chunk partials part_s (chunks, 2, c) of sum(g) and
// sum(g * xhat) for the channels [c0, c1) (sum_chunks, then the lanes in a
// fixed tree, as merge_chunks) and writes dbeta_s, dgamma_s and, for the
// other blocks of the sample, the coefficients coef_s[ch] = sum(g) / hw and
// coef_s[c + ch] = sum(g * xhat) / hw (st_published).
__device__ __forceinline__ void merge_grad_sums(const float* part_s, float* red,
                                                int c0, int c1, int c, int hw,
                                                int chunks, float* dgamma_s,
                                                float* dbeta_s, unsigned* coef_s) {
  for (int g0 = c0; g0 < c1; g0 += kThreads) {
    const int width = min(c1 - g0, kThreads);
    const int ch = g0 + threadIdx.x % width;
    float s1, s2;
    sum_chunks<false>(part_s, c, ch, threadIdx.x / width, kThreads / width,
                      chunks, 0, hw, 0.f, s1, s2);
    float sums[2][1] = {{s1}, {s2}};
    lane_sum<1, 2>(red, sums, width);
    if (threadIdx.x < width) {
      s1 = red[threadIdx.x];
      s2 = red[kThreads + threadIdx.x];
      const float fhw = (float)hw;
      dbeta_s[ch] = s1;
      dgamma_s[ch] = s2;
      st_published(coef_s + ch, s1 / fhw);
      st_published(coef_s + c + ch, s2 / fhw);
    }
    __syncthreads();
  }
}

// The one-launch backward (steps 1-5 in the header), with the ReLU gate
// (kRelu) or without. part: (n, chunks, 2,
// c) chunk partials; counters: [ticket, published (n), then each sample's
// coefficients (n, 2, c) as st_published stores them], zero at launch. At
// most 128 registers a thread, so that two blocks fit an SM.
template <typename T, int VEC, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    in_bwd_resident(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ dx,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    float* __restrict__ part, unsigned* __restrict__ counters,
                    int n, int hw, int c, int gstride, int chunk, int chunks) {
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  constexpr int kReg = bwd_reg_packs<VEC>();
  const int rp = kReg > 0 ? bwd_reg_pixels<VEC>(c) : 0;  // pixels in registers
  const size_t slab = chunk_smem_bytes(max(chunk - rp, 0), c, sizeof(T));
  T* xs = reinterpret_cast<T*>(bwd_smem_raw);
  T* gs = reinterpret_cast<T*>(bwd_smem_raw + slab);
  float* red = reinterpret_cast<float*>(bwd_smem_raw + 2 * slab);
  float* cst = red + bwd_red_floats<VEC>();  // kBwdConsts arrays of c
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x;

  // 1. ticket -> (sample, chunk)
  if (tid == 0) s_ticket = atomicAdd(counters, 1u);
  __syncthreads();
  const int s = (int)(s_ticket / (unsigned)chunks);
  const int j = (int)(s_ticket % (unsigned)chunks);
  const int p0 = j * chunk;
  const int np = min(chunk, hw - p0);
  const int sp = max(np - rp, 0);  // the chunk's pixels in shared memory
  const size_t off = ((size_t)s * hw + p0) * c;

  // 2. the chunk of x and of g, the only read of either: a thread's first
  // kReg pixels (those of the chunk's first rp) into its registers, the
  // rest into shared memory with 16-byte cp.async; the constants beside
  const Group g0 = group<VEC>(c, 0);
  Raw<T, VEC> xreg[kReg > 0 ? kReg : 1], greg[kReg > 0 ? kReg : 1];
  if (kReg > 0 && rp > 0 && g0.lane < g0.lanes) {
#pragma unroll
    for (int r = 0; r < kReg; ++r) {
      const int p = g0.lane + r * g0.lanes;
      if (p < np) {
        const size_t o = off + (size_t)p * c + g0.ch;
        xreg[r] = *reinterpret_cast<const Raw<T, VEC>*>(x + o);
        greg[r] = *reinterpret_cast<const Raw<T, VEC>*>(g + o);
      }
    }
  }
  const size_t soff = off + (size_t)rp * c;
  if constexpr (VEC > 1) {
    for (int i = tid * VEC; i < sp * c; i += kThreads * VEC) {
      cp_async16(xs + i, x + soff + i);
      cp_async16(gs + i, g + soff + i);
    }
  } else {
    for (int i = tid; i < sp * c; i += kThreads) {
      xs[i] = x[soff + i];
      gs[i] = g[soff + i];
    }
  }
  for (int k = tid; k < c; k += kThreads) {
    cst[k] = mean[(size_t)s * c + k];
    cst[c + k] = inv[(size_t)s * c + k];
    cst[2 * c + k] = gamma[(size_t)s * gstride + k];
    cst[3 * c + k] = beta[(size_t)s * gstride + k];
  }
  if constexpr (VEC > 1) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. the chunk's gated sum(g) and sum(g * xhat): a thread adds its pixels
  // in order, those in registers first
  float* pm = part + ((size_t)s * chunks + j) * 2 * c;
  for (int cv0 = 0; cv0 < c / VEC; cv0 += kThreads) {
    const Group gr = group<VEC>(c, cv0);
    float ab[2][VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) ab[0][i] = ab[1][i] = 0.f;
    if (gr.lane < gr.lanes) {
      float m[VEC], iv[VEC], ga[VEC], be[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        m[i] = cst[gr.ch + i];
        iv[i] = cst[c + gr.ch + i];
        ga[i] = cst[2 * c + gr.ch + i];
        be[i] = cst[3 * c + gr.ch + i];
      }
      if constexpr (kReg > 0) {
        if (rp > 0) {
#pragma unroll
          for (int r = 0; r < kReg; ++r) {
            if (gr.lane + r * gr.lanes < np) {
              float xv[VEC], gv[VEC];
              unpack<T, VEC>(xreg[r], xv);
              unpack<T, VEC>(greg[r], gv);
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                float xh;
                gate(xv[i], gv[i], m[i], iv[i], ga[i], be[i], kRelu, xh, gv[i]);
                ab[0][i] += gv[i];
                ab[1][i] = fmaf(gv[i], xh, ab[1][i]);
              }
              if constexpr (kRelu) greg[r] = pack<T, VEC>(gv);
            }
          }
        }
      }
#pragma unroll 2
      for (int q = gr.lane; q < sp; q += gr.lanes) {
        float xv[VEC], gv[VEC];
        load_pack<T, VEC>(xs + q * c + gr.ch, xv);
        load_pack<T, VEC>(gs + q * c + gr.ch, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xh;
          gate(xv[i], gv[i], m[i], iv[i], ga[i], be[i], kRelu, xh, gv[i]);
          ab[0][i] += gv[i];
          ab[1][i] = fmaf(gv[i], xh, ab[1][i]);
        }
        // the gated g, for step 5 (exact: each value is g's or 0)
        if constexpr (kRelu) store_pack<T, VEC>(gs + q * c + gr.ch, gv);
      }
    }
    lane_sum<VEC, 2>(red, ab, gr.width / VEC);
    for (int kk = tid; kk < gr.width; kk += kThreads) {
      pm[cv0 * VEC + kk] = red[kk];
      pm[c + cv0 * VEC + kk] = red[kThreads * VEC + kk];
    }
    __syncthreads();
  }

  // 4. hand-off within the sample: wait until every block has published,
  // merge this block's slice of the channels, then wait for every channel's
  // (a, b) from the blocks that merge them
  unsigned* coef_s = counters + 1 + n + (size_t)s * 2 * c;
  if (tid == 0) {
    unsigned* published = counters + 1 + s;
    publish(published);
    wait_count(published, (unsigned)chunks);
  }
  __syncthreads();
  // slices of a power-of-two width, for lane_sum's shuffles
  int per = 1;
  while (per * chunks < c) per *= 2;
  const int c0 = min(c, j * per);
  merge_grad_sums(part + (size_t)s * chunks * 2 * c, red, c0, min(c, c0 + per),
                  c, hw, chunks, dgamma + (size_t)s * c, dbeta + (size_t)s * c,
                  coef_s);
  for (int k = tid; k < 2 * c; k += kThreads) cst[4 * c + k] = ld_published(coef_s + k);
  __syncthreads();

  // 5. dx = gamma * inv * (g - a - xhat * b) from the registers and the
  // shared copies
  for (int cv0 = 0; cv0 < c / VEC; cv0 += kThreads) {
    const Group gr = group<VEC>(c, cv0);
    if (gr.lane >= gr.lanes) continue;
    float m[VEC], iv[VEC], ga[VEC], a[VEC], b[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = cst[gr.ch + i];
      iv[i] = cst[c + gr.ch + i];
      ga[i] = cst[2 * c + gr.ch + i];
      a[i] = cst[4 * c + gr.ch + i];
      b[i] = cst[5 * c + gr.ch + i];
    }
    if constexpr (kReg > 0) {
      if (rp > 0) {
#pragma unroll
        for (int r = 0; r < kReg; ++r) {
          const int p = gr.lane + r * gr.lanes;
          if (p < np) {
            float xv[VEC], gv[VEC];
            unpack<T, VEC>(xreg[r], xv);
            unpack<T, VEC>(greg[r], gv);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float xh = __fmul_rn(__fsub_rn(xv[i], m[i]), iv[i]);
              xv[i] = ga[i] * iv[i] * (gv[i] - a[i] - xh * b[i]);
            }
            store_pack<T, VEC>(dx + off + (size_t)p * c + gr.ch, xv);
          }
        }
      }
    }
#pragma unroll 2
    for (int q = gr.lane; q < sp; q += gr.lanes) {
      float xv[VEC], gv[VEC];
      load_pack<T, VEC>(xs + q * c + gr.ch, xv);
      load_pack<T, VEC>(gs + q * c + gr.ch, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = __fmul_rn(__fsub_rn(xv[i], m[i]), iv[i]);
        xv[i] = ga[i] * iv[i] * (gv[i] - a[i] - xh * b[i]);
      }
      store_pack<T, VEC>(dx + off + (size_t)(rp + q) * c + gr.ch, xv);
    }
  }
}

// The arguments of one backward call.
struct BwdArgs {
  const void* x;
  const void* g;
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  void* dx;
  float* dgamma;
  float* dbeta;
  float* work;
  unsigned* counters;
  int n, hw, c, gstride, chunk, chunks, relu, resident;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_bwd_two(const BwdArgs& a) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid(a.chunks, (a.c + kTileC - 1) / kTileC, a.n);
  const T* xt = static_cast<const T*>(a.x);
  const T* gt = static_cast<const T*>(a.g);
  in_bwd_partial<T><<<grid, block, 0, a.stream>>>(
      xt, gt, a.mean, a.inv, a.gamma, a.beta, a.work, a.n, a.hw, a.c, a.gstride,
      a.chunk, a.chunks, a.relu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_apply<T, false><<<grid, block, 0, a.stream>>>(
      xt, gt, a.mean, a.inv, a.gamma, a.beta, a.work, static_cast<T*>(a.dx),
      a.dgamma, a.dbeta, a.n, a.hw, a.c, a.gstride, a.chunk, a.chunks, a.relu,
      (float)a.hw);
  return cudaGetLastError();
}

// The sharded backward (fnst_instance_norm_bwd_sums, then the caller's
// all_reduce, then fnst_instance_norm_bwd_apply): the two-launch kernel's
// passes with the merge of the sums handed to the caller. sums: (2, n, c).
template <typename T>
cudaError_t launch_bwd_sums(const BwdArgs& a, float* sums) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid(a.chunks, (a.c + kTileC - 1) / kTileC, a.n);
  in_bwd_partial<T><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.mean, a.inv,
      a.gamma, a.beta, a.work, a.n, a.hw, a.c, a.gstride, a.chunk, a.chunks,
      a.relu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = a.n * a.c;
  in_bwd_sum_chunks<<<(pairs + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.work, sums, a.n, a.c, a.chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_apply_sums(const BwdArgs& a, const float* sums,
                                  float count) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid(a.chunks, (a.c + kTileC - 1) / kTileC, a.n);
  in_bwd_apply<T, true><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.mean, a.inv,
      a.gamma, a.beta, sums, static_cast<T*>(a.dx), nullptr, nullptr, a.n,
      a.hw, a.c, a.gstride, a.chunk, a.chunks, a.relu, count);
  return cudaGetLastError();
}

// The one-launch backward's counters: the ticket, one per sample and each
// sample's coefficients (2c).
size_t bwd_counters(int n, int c) { return 1 + (size_t)n * (1 + 2 * (size_t)c); }

// The smaller of the two ReLU variants' capacities.
template <typename T, int VEC>
cudaError_t bwd_capacity(int* per_sm, int* sms) {
  static CapacityCache with_relu, without;
  int per_sm2 = 0;
  cudaError_t err = capacity_of(in_bwd_resident<T, VEC, true>, with_relu, per_sm, sms);
  if (err == cudaSuccess) {
    err = capacity_of(in_bwd_resident<T, VEC, false>, without, &per_sm2, sms);
  }
  *per_sm = min(*per_sm, per_sm2);
  return err;
}

template <typename T, int VEC>
cudaError_t launch_bwd_resident(const BwdArgs& a) {
  int per_sm = 0, sms = 0;
  cudaError_t err = bwd_capacity<T, VEC>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_resident_smem<T, VEC>(a.chunk, a.c);
  // a larger G could wait forever for a block that never starts
  if (smem > (size_t)kSmemLimit || a.chunks > per_sm * sms) {
    return cudaErrorInvalidValue;
  }
  err = zero_counters(a, bwd_counters(a.n, a.c));
  if (err != cudaSuccess) return err;
  const auto kernel = a.relu ? in_bwd_resident<T, VEC, true>
                             : in_bwd_resident<T, VEC, false>;
  kernel<<<a.n * a.chunks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.mean, a.inv,
      a.gamma, a.beta, static_cast<T*>(a.dx), a.dgamma, a.dbeta, a.work,
      a.counters, a.n, a.hw, a.c, a.gstride, a.chunk, a.chunks);
  return cudaGetLastError();
}

// The backward has no statistics mode: `dispatch` is called with onepass 0.
template <typename T, int VEC, bool>
struct BwdOp {
  static cudaError_t run(const BwdArgs& a) {
    return a.resident ? launch_bwd_resident<T, VEC>(a) : launch_bwd_two<T>(a);
  }
};

template <typename T, int VEC, bool>
struct BwdCapacityOp {
  static cudaError_t run(int* per_sm, int* sms) {
    return bwd_capacity<T, VEC>(per_sm, sms);
  }
};

}  // namespace

// x, y: (n, hw, c) NHWC, f32 or bf16 (is_bf16): the first hw pixels of
// each sample, sample s at pixel s * sstride (sstride >= hw; hw for a dense
// slab). y null: the statistics-only route, which writes mean, inv and var
// and no y. gamma, beta: f32, sample
// s's row at s * gstride: one (c,) row for all (gstride 0) or (n, c) rows
// (gstride c). mean, inv: (n, c) f32 out. var: (n, c) f32 out, the
// variance inv was taken of (capture mode), or null. work: f32 scratch of
// (n, chunks, 2, c) chunk partials + (n, 2, c) scale and shift. counters:
// 1 + 2n unsigned ints, zeroed here.
// chunk: pixels per block; chunks = ceil(hw / chunk). vec: channels per
// access, 16 / itemsize (c * itemsize a multiple of 16, x and y 16-byte
// aligned) or 1. resident: the one-launch kernel, which needs chunks <=
// the capacity (fnst_instance_norm_fwd_capacity); else the two-launch
// kernel. Launches on ``stream``; returns the CUDA error code (0 on
// success). Allocates nothing.
extern "C" int fnst_instance_norm_fwd(const void* x, const void* gamma,
                                      const void* beta, void* y, void* mean,
                                      void* inv, void* var, void* work,
                                      void* counters, int n, int hw,
                                      int sstride, int c, int gstride,
                                      int chunk, int chunks, float eps,
                                      int relu, int onepass, int is_bf16,
                                      int vec, int resident, void* stream) {
  if (n < 1 || hw < 1 || sstride < hw || c < 1 || chunk < 1 || c % vec != 0 ||
      (gstride != 0 && gstride != c) || chunks != (hw + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const FwdArgs a{x, static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), y,
                  static_cast<float*>(mean), static_cast<float*>(inv),
                  static_cast<float*>(work), static_cast<unsigned*>(counters),
                  n, hw, sstride, c, gstride, chunk, chunks, eps, relu, onepass,
                  is_bf16, vec, resident, static_cast<cudaStream_t>(stream),
                  StatsIO{static_cast<float*>(var), nullptr, nullptr, 0, 1.f,
                          0.f},
                  0};
  return dispatch<FwdOp>(is_bf16, vec, onepass, a);
}

// The inject mode: normalizes x with reference moments ref_mean, ref_var
// (f32, sample s's row at s * rstride: rstride 0 for one (c,) row, c for
// (n, c) rows), blended with x's own stable moments as blend * ref + keep *
// own (keep = 1 - blend). route 0: blend 1, the reference moments alone:
// in_fwd_inject, one launch, no statistics pass (mean, var and work
// unused; inv written). route 1 (one-launch, in_fwd_resident) or 2
// (two-launch, in_fwd_partial + in_fwd_apply): the statistics pass as in
// fnst_instance_norm_fwd, its merge blending; mean and var (if not null)
// get x's own moments, inv the blended one. Other arguments as for
// fnst_instance_norm_fwd. Returns the CUDA error code (0 on success).
extern "C" int fnst_instance_norm_fwd_stats(
    const void* x, const void* gamma, const void* beta, const void* ref_mean,
    const void* ref_var, void* y, void* mean, void* inv, void* var, void* work,
    void* counters, int n, int hw, int sstride, int c, int gstride,
    int rstride, int chunk, int chunks, float eps, float blend, float keep,
    int relu, int is_bf16, int vec, int route, void* stream) {
  if (n < 1 || hw < 1 || sstride < hw || c < 1 || chunk < 1 || c % vec != 0 ||
      y == nullptr ||
      (gstride != 0 && gstride != c) || (rstride != 0 && rstride != c) ||
      route < 0 || route > 2 || ref_mean == nullptr || ref_var == nullptr ||
      chunks != (hw + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const FwdArgs a{x, static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), y,
                  static_cast<float*>(mean), static_cast<float*>(inv),
                  static_cast<float*>(work), static_cast<unsigned*>(counters),
                  n, hw, sstride, c, gstride, chunk, chunks, eps, relu, 0,
                  is_bf16, vec, route == 1, static_cast<cudaStream_t>(stream),
                  StatsIO{static_cast<float*>(var),
                          static_cast<const float*>(ref_mean),
                          static_cast<const float*>(ref_var), rstride, blend,
                          keep},
                  route == 0};
  return dispatch<FwdOp>(is_bf16, vec, 0, a);
}

// Blocks of the one-launch kernel the current device holds at once, for
// the variant (is_bf16, vec, onepass): blocks per SM at its largest shared
// memory, and the SM count. Returns the CUDA error code (0 on success).
extern "C" int fnst_instance_norm_fwd_capacity(int is_bf16, int vec,
                                               int onepass, int* blocks_per_sm,
                                               int* sms) {
  return dispatch<CapacityOp>(is_bf16, vec, onepass, blocks_per_sm, sms);
}

// x, g, dx: (n, hw, c) NHWC in one dtype, f32 or bf16 (is_bf16). mean, inv:
// (n, c) f32 residuals of the forward. gamma, beta: f32, sample s's row at
// s * gstride, gstride 0 ((c,)) or c ((n, c)). dgamma, dbeta:
// (n, c) f32 out, per sample. work: f32 scratch of 2 * n * chunks * c
// chunk partials. counters: 1 + n (1 + 2c) unsigned ints, zeroed here (the
// one-launch kernel's hand-off). chunk: pixels per block; chunks = ceil(hw /
// chunk). vec: channels per access, 16 / itemsize (c * itemsize a multiple
// of 16, x, g and dx 16-byte aligned) or 1. resident: the one-launch
// kernel, which needs chunks <= the capacity
// (fnst_instance_norm_bwd_capacity); else the two-launch kernel. Launches
// on ``stream``; returns the CUDA error code (0 on success). Allocates
// nothing.
extern "C" int fnst_instance_norm_bwd(const void* x, const void* g,
                                      const void* mean, const void* inv,
                                      const void* gamma, const void* beta,
                                      void* dx, void* dgamma, void* dbeta,
                                      void* work, void* counters, int n,
                                      int hw, int c, int gstride, int chunk,
                                      int chunks, int relu, int is_bf16, int vec,
                                      int resident, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  if (n < 1 || hw < 1 || c < 1 || chunk < 1 || vec < 1 || c % vec != 0 ||
      (gstride != 0 && gstride != c) || (vec > 1 && ptrs % 16 != 0) ||
      chunks != (hw + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const BwdArgs a{x, g, static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), dx,
                  static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                  static_cast<float*>(work), static_cast<unsigned*>(counters),
                  n, hw, c, gstride, chunk, chunks, relu, resident,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<BwdOp>(is_bf16, vec, 0, a);
}

// Blocks of the one-launch backward kernel the current device holds at
// once, for the variant (is_bf16, vec): blocks per SM at its largest shared
// memory, and the SM count. Returns the CUDA error code (0 on success).
extern "C" int fnst_instance_norm_bwd_capacity(int is_bf16, int vec,
                                               int* blocks_per_sm, int* sms) {
  return dispatch<BwdCapacityOp>(is_bf16, vec, 0, blocks_per_sm, sms);
}

// The sharded backward, pass 1 (no extent: every pixel of the slab counts):
// sums (2, n, c) f32 out, each (sample, channel)'s gated sum(g) and sum(g *
// xhat) over this rank's hw pixels, xhat from the global (mean, inv). The
// two-launch backward's in_bwd_partial, whose chunk partials (work: 2 * n *
// chunks * c f32) in_bwd_sum_chunks then adds in chunk order. The caller sums
// them over the ranks (the all_reduce) and passes the totals to
// fnst_instance_norm_bwd_apply; these local sums are also the rank's share
// of dbeta and dgamma. Other arguments as for fnst_instance_norm_bwd.
extern "C" int fnst_instance_norm_bwd_sums(const void* x, const void* g,
                                           const void* mean, const void* inv,
                                           const void* gamma, const void* beta,
                                           void* sums, void* work, int n,
                                           int hw, int c, int gstride,
                                           int chunk, int chunks, int relu,
                                           int is_bf16, void* stream) {
  if (n < 1 || hw < 1 || c < 1 || chunk < 1 || (gstride != 0 && gstride != c) ||
      chunks != (hw + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const BwdArgs a{x, g, static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), nullptr, nullptr, nullptr,
                  static_cast<float*>(work), nullptr, n, hw, c, gstride, chunk,
                  chunks, relu, 0, static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(sums);
  return is_bf16 ? launch_bwd_sums<__nv_bfloat16>(a, out)
                 : launch_bwd_sums<float>(a, out);
}

// The sharded backward, pass 2: dx = gamma * inv * (g - a - xhat * b) over
// this rank's pixels, a = sums[0] / count and b = sums[1] / count from the
// totals over every rank (sums: (2, n, c) f32, count: the pixels of a sample
// over all the ranks); x and g are read a second time. The two-launch
// backward's in_bwd_apply with the sums given. Other arguments as for
// fnst_instance_norm_bwd_sums.
extern "C" int fnst_instance_norm_bwd_apply(const void* x, const void* g,
                                            const void* mean, const void* inv,
                                            const void* gamma, const void* beta,
                                            const void* sums, void* dx, int n,
                                            int hw, int c, int gstride,
                                            int chunk, int chunks, float count,
                                            int relu, int is_bf16,
                                            void* stream) {
  if (n < 1 || hw < 1 || c < 1 || chunk < 1 || !(count >= (float)hw) ||
      (gstride != 0 && gstride != c) || chunks != (hw + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const BwdArgs a{x, g, static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), dx, nullptr, nullptr,
                  nullptr, nullptr, n, hw, c, gstride, chunk, chunks, relu, 0,
                  static_cast<cudaStream_t>(stream)};
  const float* in = static_cast<const float*>(sums);
  return is_bf16 ? launch_bwd_apply_sums<__nv_bfloat16>(a, in, count)
                 : launch_bwd_apply_sums<float>(a, in, count);
}
