// Moment attention for AdaAttN (Liu et al., ICCV 2021), for Hopper (sm_90a).
//
// fnst_moment_attention computes, for every query row i of a batch of
// content images,
//     A    = softmax(q_i . k_j over the keys j)        (scale 1, no 1/sqrt(d))
//     M    = sum_j A_j v1_j                            (the first moment)
//     E2   = sum_j A_j v2_j                            (the second moment)
//     out  = sqrt(max(E2 - M^2, 0)) * c_i + M + shift
// with q (B, Nq, Dqk) the queries f(K_c), k (Nk, Dqk) the cached style keys
// g(K_s), v1 = h(F_s) - shift and v2 = v1^2, both cached per style and
// stored transposed, (2, Dv, Nkp) with the keys padded with zeros to Nkp, a
// multiple of 8; shift (Dv,) f32, and c (B, Nq, Dv) norm(F_c), read in
// place from the last Dv channels of the content key buffer (row stride
// c_stride). q, k, v1, v2, c and out are bf16; every product is summed in
// fp32, and both moments stay in fp32 until the epilogue, so E2 - M^2
// cancels in fp32, not in bf16.
//
// Replaces no TPU kernel: the JAX package has no AdaAttN. It was added
// because no attention of PyTorch's computes this: the query and key width
// (448, 960, 1472) differs from the value width (256, 512), the logits are
// not scaled, and the output needs the weighted second moment and the
// epilogue with c. The composition it replaces (bmm, softmax, two bmms,
// the epilogue) writes the Nq x Nk scores and weights to device memory.
//
// The shift. AdaAttN's variance is E[v^2] - E[v]^2 over the attention
// weights, which cancels where |M| >> S. The caller stores v1 = v - shift
// with shift the style's channel mean over its keys (computed in fp32 once
// per style, ops/cuda_moment_attention.py::prepare_values): the variance
// does not change, the moments of v1 are of the size of the spread, and
// v2 is the square of the bf16 v1, formed in fp32 and rounded to bf16 once
// per style, so the kernel reads both as tensor-core operands and forms no
// square itself. The weights given to both moments are the same
// bf16-rounded p_j, and their sum l is the sum of those rounded values, so
// the weights the epilogue divides by sum to one: E2 - M^2 is the variance
// of v1 under one set of weights, >= 0 up to fp32 rounding.
//
// Bound: operations, 2 Nq Nk (Dqk + 2 Dv) a batch image, at the sizes
// AdaAttN serves (at relu5_1, 1024 x 1024 a 512^2 image, it is mostly
// latency). Design: FlashAttention-2's loop on Hopper's warpgroup MMA
// (wgmma, bf16 in, fp32 accumulators) fed by the tensor memory accelerator
// (TMA). A block is two warpgroups (256 threads) on the same 64 query rows
// of one image; warpgroup w owns DV = 128 value columns (the block's 2 DV),
// and both walk the key tiles of 64 keys with one online softmax each. A
// key tile's scores take Dqk / 64 steps; a step multiplies a 64 x 64 chunk
// of q by one of k with four wgmma m64n64k16 that read both from shared
// memory, where both warpgroups read the same chunks. q stays resident
// (all its chunks, copied on the first key tile) where shared memory holds
// it beside the rest (Dqk <= 1024: relu3_1, relu4_1), and is copied a chunk
// a step beside k's otherwise (relu5_1). Thread 0 issues every copy, one
// TMA box of 64 x 64 (q, k) or 128 x 64 (v1, v2) each, two steps ahead into
// four stages, each completing on its stage's mbarrier: at step s the
// copies for s + 2 go to the stage of step s - 2, whose products every warp
// has waited for (after issuing step s - 1's) before the step's barrier,
// so one barrier a step suffices and step s's products overlap step
// s + 1's wait. The probabilities go from the score accumulators into
// registers as the A operand of the value products (wgmma m64n128k16, A
// from registers, v1 and v2 from shared memory), issued once a tile after
// the tile's own mbarrier for v and waited for before the next tile's first
// barrier. The TMA boxes land in rows of 128 bytes with the 128-byte
// swizzle (16-byte chunk c of row r at c ^ (r mod 8)), the layout the wgmma
// descriptors name, in 1024-byte aligned tiles; rows past a tensor's end
// land as zeros. No register that a wgmma in flight accumulates into is
// touched by other instructions (ptxas serializes the wgmma otherwise:
// C7515). A block holds up to 218 KB of shared memory (relu4_1's q) and
// 210 registers a thread: one block an SM. The epilogue writes bf16.
//
// Measured at the three sites' 512^2 shapes (B = 8, H100, CUDA events):
// 3.55 / 2.96 / 0.29 ms against 6.47 / 5.73 / 0.53 for the first wgmma
// version (one warpgroup a block, two blocks an SM, q and k by cp.async
// every step). What was found on the way: with the loads alone (no
// products) the cp.async version took 5.0 of its 5.7 ms at relu3_1 and
// its products alone 2.7; copying two, six or eight steps ahead, another
// key order a block, or half the bytes of v (squaring v1 in shared memory)
// moved nothing or cost time, so the copy instructions themselves, not the
// bytes or their latency, held it back; TMA removed them. Splitting q . k's
// chunks between the two warpgroups (each sums half, the two fp32 partial
// sums exchanged through two spent k stages) halves the score products but
// ran 1.46x slower at relu3_1, 1.34x even without the exchange: two
// warpgroups reading the same q and k tiles outrun two reading one each.
//
// The cost of splitting Dv: the value accumulators of both moments for 64
// rows x DV columns take 2 * DV / 2 registers a thread (128 at DV = 128,
// with the 32 of the scores), so a warpgroup cannot hold all of Dv; both
// warpgroups of a block compute the same scores, and the Dv / 256 blocks
// of a query tile each again. The scores are Dqk / (Dqk + 2 DV) of a
// warpgroup's work, so the kernel does (Dv / 128 * Dqk + 2 Dv) / (Dqk +
// 2 Dv) times the useful operations: 1.47x at relu3_1 (Dqk 448, Dv 256),
// 2.45x at relu4_1 (960, 512), 2.77x at relu5_1 (1472, 512). The roofline
// share counts the useful ones only.
//
// Needs: Dqk a multiple of 64, Dv of 128, q, k and the values' rows
// 16-byte aligned (the wrapper checks); any Nq and Nk >= 1 (the ragged
// tiles load zeros, the missing keys get weight 0, the missing rows are
// not written).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;    // a block: two warpgroups on the same query rows
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBq = 64;           // query rows a block
constexpr int kBk = 64;           // keys a tile
constexpr int kBd = 64;           // query and key columns a step: one 128-byte row
constexpr int kDv = 128;          // value columns a warpgroup
constexpr int kNtv = kDv / 8;     // value n-tiles of a thread's rows
constexpr int kTile = 64 * 64;    // elements of a 64 x 64 tile (8 KB)
constexpr int kAhead = 2;         // steps whose copies are in flight
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle: start address, 1024 bytes from one group of 8 rows to the next
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators' reads and writes after the last wait: wgmma
// writes them asynchronously, which the compiler does not see
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a (64 x 16, shared memory) * b (16 x 64, shared memory), fp32
// accumulators: the scores of 64 queries and 64 keys over 16 columns
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a (64 x 16, registers) * b (16 x 128, shared memory), fp32
// accumulators: a moment of 64 queries' 128 value columns over 16 keys
__device__ __forceinline__ void wgmma_moment(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  float2 back = __bfloat1622float2(p);
  sum += back.x + back.y;  // the rounded weights, so that they sum to l
  return *reinterpret_cast<uint32_t*>(&p);
}


// -- the tensor memory accelerator (TMA) and its barriers --------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// the barriers' initialisation made visible to the TMA unit
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the barrier's phase of this parity to complete; traps (an error
// on the launch, not a hang) if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  for (int i = 0; !mbar_try(a, parity); ++i)
    if (i > (1 << 24)) __trap();
}

// a box of a 2-D tensor map (inner coordinate c0, outer c1) into shared
// memory, completing on `bar`; rows outside the tensor are filled with zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a warpgroup's v1 and v2 of one key tile (elements)
constexpr int kVTile = 2 * kDv * kBk;
// the most dynamic shared memory a block may take on sm_90
constexpr int kSmemMax = 227 * 1024;

struct Maps {  // the tensor maps of q, k and v, passed by value
  CUtensorMap q, k, v;
};

// shared memory of a block whose copies run `ahead` steps ahead: its
// ahead + 2 stages of k chunks, its q chunks (all Dqk / 64 of them when q
// stays resident, else a chunk a stage), both warpgroups' v1 and v2, the
// barriers, and 1024 bytes to align the first to 1024
__host__ __device__ constexpr int smem_bytes(int nd, bool resident, int ahead) {
  return ((resident ? nd : ahead + 2) + ahead + 2) * kTile * 2 + kWarpgroups * kVTile * 2 +
         128 + 1024;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    moment_attention_kernel(const __grid_constant__ Maps maps, const float* __restrict__ shift,
                            const __nv_bfloat16* __restrict__ c,
                            __nv_bfloat16* __restrict__ out, int nq, int nk, int dqk, int dv,
                            int c_stride) {
  constexpr int kStages = kAhead + 2;  // kAhead steps in flight, two in use
  extern __shared__ uint8_t smem_raw[];
  const int nd = dqk / kBd;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* s_k = s_q + (kResident ? nd : kStages) * kTile;
  __nv_bfloat16* s_v = s_k + kStages * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_v + kWarpgroups * kVTile);  // a stage's
  uint64_t* v_full = full + kStages;

  // warpgroup wg owns value columns dv0 .. dv0 + DV of the block's query rows;
  // where Dv = 128 the second owns none, and computes without writing
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBq, b = blockIdx.z;
  const int dv0 = (blockIdx.y * kWarpgroups + wg) * kDv;
  const int nkt = (nk + kBk - 1) / kBk;
  const int steps = nkt * nd;

  // thread 0 issues every copy: step s's k chunk, with its q chunk on the
  // first key tile (resident) or on every tile (streamed)
  auto issue_step = [&](int s) {
    const int kt = s / nd, d = s - kt * nd, st = s % kStages;
    const bool with_q = !kResident || kt == 0;
    mbar_expect_tx(full + st, (with_q ? 2 : 1) * kTile * 2);
    if (with_q)
      tma_load_2d(s_q + (kResident ? d : st) * kTile, &maps.q, d * kBd, b * nq + q0, full + st);
    tma_load_2d(s_k + st * kTile, &maps.k, d * kBd, kt * kBk, full + st);
  };
  // key tile kt's v1 and v2 rows of both warpgroups
  auto issue_v = [&](int kt) {
    mbar_expect_tx(v_full, kWarpgroups * kVTile * 2);
#pragma unroll
    for (int w = 0; w < kWarpgroups; ++w)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        tma_load_2d(s_v + w * kVTile + m * kDv * kBk, &maps.v, kt * kBk,
                    m * dv + (blockIdx.y * kWarpgroups + w) * kDv, v_full);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kAhead && s < steps; ++s) issue_step(s);

  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  float o1[4 * kNtv], o2[4 * kNtv];
#pragma unroll
  for (int i = 0; i < 4 * kNtv; ++i) o1[i] = o2[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    float sc[32];  // the tile's first product overwrites them
    for (int d = 0; d < nd; ++d) {
      const int s = kt * nd + d;
      // every warp's products of step s - 2 are done (its wait at the end of
      // step s - 1), and of the value products of tile kt - 1 (their wait):
      // their buffers may be refilled
      __syncthreads();
      if (threadIdx.x == 0) {
        if (s + kAhead < steps) issue_step(s + kAhead);  // into the stage of step s - 2
        if (d == 0) issue_v(kt);
      }
      mbar_wait(full + s % kStages, (s / kStages) & 1);
      const uint64_t dq = desc(s_q + (kResident ? d : s % kStages) * kTile);
      const uint64_t dk = desc(s_k + (s % kStages) * kTile);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBd / 16; ++ks)  // 16 columns = 32 bytes = 2 descriptor units
        wgmma_scores(sc, dq + 2 * ks, dk + 2 * ks, d > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // step s - 1's products are done: its stage may be refilled
    }
    wgmma_wait<0>();
    fence_regs(sc);

    // a thread holds rows g = 16 warp + lane / 4 (j < 2) and g + 8 (j >= 2)
    // of n-tile nt as sc[4 nt + j], columns 8 nt + 2 (lane % 4) + (j % 2)
    if ((kt + 1) * kBk > nk) {  // the ragged last tile: missing keys weigh 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * kBk + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1) >= nk) sc[i] = -INFINITY;
    }
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * nt], sc[4 * nt + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m_row[h] - mx[h]) * kLog2e);  // 0 on the first tile
      m_row[h] = mx[h];
    }
    uint32_t p[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      p[nt][0] = pack_bf16(exp2f((sc[4 * nt] - mx[0]) * kLog2e),
                           exp2f((sc[4 * nt + 1] - mx[0]) * kLog2e), rs[0]);
      p[nt][1] = pack_bf16(exp2f((sc[4 * nt + 2] - mx[1]) * kLog2e),
                           exp2f((sc[4 * nt + 3] - mx[1]) * kLog2e), rs[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_row[h] = l_row[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int i = 0; i < 4 * kNtv; ++i) {
      o1[i] *= alpha[(i >> 1) & 1];
      o2[i] *= alpha[(i >> 1) & 1];
    }

    // both moments: the weights as the A operand, v1 and v2 from shared memory
    mbar_wait(v_full, kt & 1);
    const uint64_t dv1 = desc(s_v + wg * kVTile), dv2 = desc(s_v + wg * kVTile + kDv * kBk);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      const uint32_t a[4] = {p[2 * ks][0], p[2 * ks][1], p[2 * ks + 1][0], p[2 * ks + 1][1]};
      wgmma_moment(o1, a, dv1 + 2 * ks);
      wgmma_moment(o2, a, dv2 + 2 * ks);
    }
    wgmma_commit();
    wgmma_wait<0>();  // before the next tile refills v, and rescales o1, o2
    fence_regs(o1);
    fence_regs(o2);
  }
  if (dv0 >= dv) return;

  // epilogue: sqrt(max(E2 - M^2, 0)) * c + M + shift, in fp32, out in bf16
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    if (row >= nq) continue;
    const float inv = 1.f / l_row[h];
    const __nv_bfloat16* crow = c + (static_cast<size_t>(b) * nq + row) * c_stride + dv0;
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * nq + row) * dv + dv0;
#pragma unroll
    for (int nt = 0; nt < kNtv; ++nt) {
      const int col = nt * 8 + 2 * t, i = 4 * nt + 2 * h;
      const float m0 = o1[i] * inv, m1 = o1[i + 1] * inv;
      const float s0 = sqrtf(fmaxf(o2[i] * inv - m0 * m0, 0.f));
      const float s1 = sqrtf(fmaxf(o2[i + 1] * inv - m1 * m1, 0.f));
      const float2 cc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + col));
      const float2 sh = *reinterpret_cast<const float2*>(shift + dv0 + col);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(fmaf(s0, cc.x, m0 + sh.x), fmaf(s1, cc.y, m1 + sh.y));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry points (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 matrix of `outer` rows of `inner` elements (rows `row_elems` apart),
// read in boxes of box_outer x 64 with the 128-byte swizzle wgmma reads
bool make_map(CUtensorMap* map, const void* base, int inner, long long outer, int row_elems,
              int box_outer) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_elems) * 2};
  const cuuint32_t box[2] = {kBd, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kResident>
int launch_variant(const Maps& maps, const void* shift, const void* c, void* out, int batch,
                   int nq, int nk, int dqk, int dv, int c_stride, cudaStream_t stream) {
  static bool attributed = false;  // the opt-in above 48 KB, once a process and variant
  if (!attributed) {
    cudaError_t err = cudaFuncSetAttribute(moment_attention_kernel<kResident>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    attributed = true;
  }
  dim3 grid((nq + kBq - 1) / kBq, (dv + kWarpgroups * kDv - 1) / (kWarpgroups * kDv), batch);
  moment_attention_kernel<kResident>
      <<<grid, kThreads, smem_bytes(dqk / kBd, kResident, kAhead), stream>>>(
          maps, static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(c),
          static_cast<__nv_bfloat16*>(out), nq, nk, dqk, dv, c_stride);
  return static_cast<int>(cudaGetLastError());
}

// q resident where it fits, else streamed a chunk a step beside k's
int launch(const void* q, const void* k, const void* v, const void* shift, const void* c,
           void* out, int batch, int nq, int nk, int nkp, int dqk, int dv, int c_stride,
           cudaStream_t stream) {
  Maps maps;
  if (!make_map(&maps.q, q, dqk, static_cast<long long>(batch) * nq, dqk, kBq) ||
      !make_map(&maps.k, k, dqk, nk, dqk, kBk) || !make_map(&maps.v, v, nkp, 2 * dv, nkp, kDv))
    return 1001;
  return (smem_bytes(dqk / kBd, true, kAhead) <= kSmemMax ? launch_variant<true>
                                                          : launch_variant<false>)(
      maps, shift, c, out, batch, nq, nk, dqk, dv, c_stride, stream);
}

}  // namespace

extern "C" {

// q (batch, nq, dqk), k (nk, dqk), v (2, dv, nkp) [v1; v2] transposed, the
// keys padded to nkp >= nk, a multiple of 8; shift (dv,) f32, c rows of
// c_stride elements (batch * nq of them), out (batch, nq, dv). Returns a
// CUDA error code, 0 on success; 1000 for a shape the kernel does not take,
// 1001 where the tensor-map encoder is missing or refuses one.
int fnst_moment_attention(const void* q, const void* k, const void* v, const void* shift,
                          const void* c, void* out, int batch, int nq, int nk, int nkp,
                          int dqk, int dv, int c_stride, void* stream) {
  if (batch < 1 || nq < 1 || nk < 1 || nkp < nk || nkp % 8 || dqk % kBd ||
      dv % kDv || c_stride % 8)
    return 1000;
  return launch(q, k, v, shift, c, out, batch, nq, nk, nkp, dqk, dv, c_stride,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
