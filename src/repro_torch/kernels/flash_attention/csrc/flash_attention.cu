// Causal / non-causal flash attention for Hopper (sm_90a): kernel K4.
//
// out (B, S, H, D) f32 = softmax(q k^T / sqrt(D)) v for every (batch, head),
// q (B, S, H, D) and k, v (B, S, KV, D) in bf16 or f32, H a multiple of KV:
// query head h reads KV head h / (H / KV), which is what the reference's
// jnp.repeat(k, rep, axis=2) gives.  The three inputs are read in place
// through their strides (the last dimension contiguous): no transposed or
// head-repeated copy of q, k or v exists.
//
// Replaces the JAX package's kernels/flash_attention/kernel.py:76,
// flash_attention_kernel (body _flash_kernel, :28).  There the TPU grid
// (BH, S/bq, S/bk) ran in order, carrying the running max, sum and f32
// accumulator of one query tile in VMEM scratch across the sequential key
// steps, and causally future key tiles were GATED: the grid still visited
// them and pl.when switched their compute off.  Here one thread block owns
// one (batch*head, 64-row query tile) and walks the key tiles itself, with
// the running statistics in registers.  Under causal masking its key loop
// STOPS AT THE DIAGONAL: future key tiles are never visited, so this is
// SKIP, not GATE, and only the last tile visited (the diagonal one) is
// masked.  The numerics are the same (a gated tile changed nothing in the
// reference either).  Per key tile, as _flash_kernel: scores in f32 times
// 1/sqrt(D), masked to -1e30 where the key is in the query's future or
// past S, m_new = max(m, rowmax), corr = exp(m - m_new), p = exp(s -
// m_new), l = l*corr + rowsum(p) in f32 over the unrounded p, acc =
// acc*corr + p@v with p rounded to v's type before the product (bf16: p
// rounded to bf16, the products summed in f32), and out = acc / max(l,
// 1e-30) at the end.  The key tiles are the kernel's own; the wrapper's bq
// and bk only decide which shapes are legal, as the reference's assert does.
//
// What bounds it: at the serve prefill cell (B 8, S 512, H 14, KV 2, D 64,
// bf16, causal) the function moves 24 MB (q, k, v read once, f32 out
// written once: 7.2 us at 3.35 TB/s on an H100) and needs 3.8 GFLOP (3.8
// us at the bf16 tensor-core rate), so its bound is the bytes.  The first
// version of this kernel did both products on the f32 FMA pipes (67
// TFLOP/s: 56 us for this work) from f32 tiles that a synchronous loop
// converted and stored transposed between two barriers, so loads and
// compute never overlapped; it took 0.166 ms there.  Two variants now,
// chosen by type (flash_attention_info below):
//
// bf16: wgmma and a TMA ring (wg_kernel).  One consumer warpgroup owns
// the 64-row query tile and issues wgmma for both products, reading Q
// and K (K-major) and V (MN-major) straight from shared memory, so no
// warp copies a K/V tile into registers; a producer warp keeps K/V tiles
// of 64 keys arriving by TMA (one thread, boxes of 64 rows, rows past S
// zero-filled) into a ring of 2 stages with a "full" and an "empty"
// mbarrier each, so loads never wait for compute.  A tile is stored in
// column pieces of 64, 32 or 16 bf16 (the widest that divides the
// kernel's width: two of 64 at D 128, five of 16 at D 80), each piece's
// rows swizzled by TMA in 128, 64 or 32 bytes as the wgmma descriptors
// expect.  The TMA maps are built per call on the host and passed as
// __grid_constant__ parameters.
// The softmax runs on the S accumulator fragments (row max and row sum
// over the 4 threads of a quad), and P stays in registers: an S
// fragment, rounded to bf16, is the register A operand of O += P V.
// exp(x - m) is 2^(x log2 e - m log2 e) on the hardware's ex2 (relative
// error about 2^-22, far below the bf16 rounding of p that follows).
// What bounds it: the chain inside one warpgroup, wgmma -> softmax ->
// wgmma, per 64-key tile.  Resident blocks hide it: the registers are
// capped so that 4 blocks fit on an SM at D <= 64 (2 at D 80 to 160; at
// D 192 and 256 the ring's shared memory leaves room for one), and one
// block's softmax runs while another's wgmma does.  Issuing the next
// tile's Q K^T before the softmax inside one warpgroup was slower: the
// compiler moved the softmax behind the wait for both products.
//
// f32: the FMA kernel (fma_kernel), unchanged from the first version,
// bound by the f32 FMA pipes.  It is faster than PyTorch's f32 attention
// at the serve shape, and the tensor cores' TF32 would keep only about
// three decimal digits of the products, where the f32 checks (the kernel
// against its plain version at 1e-5, the card's prefill logits against
// the CPU path at 1e-4) need full f32.  Each thread of its 16 x 16 block
// holds a 4 x (BK/16) tile of scores and a 4 x (D/16) tile of the
// accumulator from f32 tiles in shared memory.
//
// Head dims: the reference's K4 takes the whole head as one block, so any
// D.  Both variants are compiled at the widths 16, 32, 48, 64, 80 (bf16
// only), 96, 112, 128, 160, 192 and 256 (by_width); heads of D from 1 to
// 256 run the first width at least as wide, the missing columns read as
// zeros (the TMA map carries the true D, so its boxes zero-fill past it;
// the f32 loads are predicated), and only the true D columns are
// written.  The
// scale stays 1/sqrt(true D).  The PV product at a width that is not one
// wgmma's N is a few wgmmas side by side (wgmma_pv); at D 256 the O
// accumulator alone is 128 registers a thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda.h>  // CUtensorMap and its enums; no -lcuda (see encoder())
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per thread block (both variants)
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the last dimension is contiguous
};

// ---------------------------------------------------------------------
// f32: the FMA kernel
// ---------------------------------------------------------------------
constexpr int FMA_THREADS = 256;  // 16 x 16
constexpr int QS = BQ + 4;        // row stride of the k-major q and p tiles

template <int D>
struct FmaTile {
  static constexpr int BK = D <= 64 ? 64 : 32;  // keys per step
  static constexpr int NJ = BK / 16;            // score columns per thread
  static constexpr int NC = D / 16;             // acc columns per thread
  static constexpr int KS = BK + 1;             // row stride of k^T tile
  // q^T (D x QS) | k^T (D x KS) | v (BK x D) | p^T (BK x QS), all f32
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + D * QS;
  static constexpr int V_OFF = K_OFF + D * KS;
  static constexpr int P_OFF = V_OFF + BK * D;
  static constexpr size_t SMEM = (size_t)(P_OFF + BK * QS) * sizeof(float);
};

// reductions over the 16 threads (one half-warp) that share a row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Thread block: 256 threads as 16 x 16 (ty, tx); thread (ty, tx) owns
// query rows ty*4 .. ty*4+3 of the tile, key columns tx + 16 j and
// accumulator columns tx + 16 c.  A row's 16 threads are one half-warp.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FMA_THREADS)
    fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int S,
               int H, int rep, int dh, Strides qs, Strides ks, Strides vs,
               float scale) {
  using Geo = FmaTile<D>;
  constexpr int BK = Geo::BK, NJ = Geo::NJ, NC = Geo::NC, KS = Geo::KS;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem + Geo::Q_OFF;  // Qt[d * QS + r]
  float* Kt = smem + Geo::K_OFF;  // Kt[d * KS + c]
  float* Vs = smem + Geo::V_OFF;  // Vs[c * D + d]
  float* Pt = smem + Geo::P_OFF;  // Pt[c * QS + r]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / rep;
  // the last query tiles have the most keys under causal masking: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  for (int e = tid; e < BQ * D; e += FMA_THREADS) {
    const int r = e / D, d = e % D;
    Qt[d * QS + r] = q0 + r < S && d < dh ? qb[(q0 + r) * qs.s + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (S + BK - 1) / BK;
  // SKIP: under causal masking no key tile past the diagonal is visited
  const int kt_end = CAUSAL ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += FMA_THREADS) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < S && d < dh;
      Kt[d * KS + c] = in ? kb[(k0 + c) * ks.s + d] : 0.f;
      Vs[c * D + d] = in ? vb[(k0 + c) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[0][j] = fmaf(qv.x, kv[j], s[0][j]);
        s[1][j] = fmaf(qv.y, kv[j], s[1][j]);
        s[2][j] = fmaf(qv.z, kv[j], s[2][j]);
        s[3][j] = fmaf(qv.w, kv[j], s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= S || (CAUSAL && kp > qp)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * QS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c0 = 0; c0 < BK; ++c0) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c0 * QS + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[c0 * D + tx + 16 * c];
        acc[0][c] = fmaf(pv.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pv.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pv.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pv.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * S + qp) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < dh) o[tx + 16 * c] = acc[i][c] / den;
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma on the tensor cores, K/V tiles by TMA
// ---------------------------------------------------------------------
// One consumer warpgroup (warps 0-3) owns the 64-row query tile and
// issues wgmma for both products; one producer warp (warp 4) keeps K/V
// tiles arriving by TMA into a ring of STAGES stages, each stage with a
// "full" barrier (TMA bytes landed) and an "empty" barrier (the consumer
// has read it).  Tiles are stored as TMA's swizzle writes them: rows of
// D bf16 (32, 64 or 128 bytes, swizzled in as many bytes), 8-row atoms;
// D 128 is two 64-column halves of 128-byte rows.
constexpr int WG_THREADS = 160;  // 4 consumer warps + 1 producer warp
constexpr int BK = 64;           // keys per tile

template <int D>
struct WgTile {
  // bf16 per stored row: the widest of 64, 32 and 16 that divides D
  static constexpr int ROW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int ROW_BYTES = 2 * ROW;     // = the swizzle width
  static constexpr int ATOM = 8 * ROW_BYTES;    // 8 rows: one swizzle atom
  static constexpr int HALVES = D / ROW;        // column pieces of a tile
  // the descriptor's and the TMA map's swizzle: 128, 64 or 32 bytes
  static constexpr unsigned LAYOUT =
      ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  // resident blocks per SM the register allocation must allow: above
  // D 160 the ring's shared memory leaves room for one
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : D <= 160 ? 2 : 1;
  static constexpr int STAGES = 2;
  static constexpr int HALF_BYTES = 64 * ROW_BYTES;
  static constexpr int TILE_BYTES = HALVES * HALF_BYTES;
  static constexpr int NO = D / 2;  // O accumulator floats per thread
  // Q | K0 V0 | K1 V1 | ... | barriers (full, empty, q), at a 1024-byte
  // aligned base (the allocation has 1024 bytes of slack)
  static constexpr int BAR_OFF = (1 + 2 * STAGES) * TILE_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 2^x by the hardware's ex2 unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that lasts
// seconds can only be a fault of the kernel: it traps (the launch fails)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned long long t0 = 0;
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 1023) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// A 64 x 64 box (cols c0.., rows r0..) of head h, batch b, by TMA
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map,
                                        unsigned bar, int c0, int r0, int h,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma descriptor of a swizzled operand at shared address `addr`: lbo
// and sbo in bytes (sbo: from one 8-row atom to the next), layout 1, 2 or
// 3 for the 128-, 64- or 32-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo, unsigned layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
__device__ __forceinline__ void pin(unsigned (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x 64 f32) = or += a (64 x 16 bf16, shared, K-major) b^T
// (64 x 16 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16 f32) += a (64 x 16 bf16, registers) b (16 x 16 bf16,
// shared, MN-major)
template <int O, int NO>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[NO],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32 f32) += a (64 x 16 bf16, registers) b (16 x 32 bf16,
// shared, MN-major)
template <int O, int NO>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NO],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 f32) += a (64 x 16 bf16, registers) b (16 x 64 bf16,
// shared, MN-major)
template <int O, int NO>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NO],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += a (64 x 16 bf16, registers) b (16 x 128 bf16,
// shared, MN-major)
template <int O, int NO>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[NO],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O[:, C0:D) += P V[:, C0:D) for one k16 step whose V rows start at
// shared address `v`: the widest of n128, n64, n32, n16 that fits, then
// the rest.  A column C0 starts piece C0 / ROW of the tile (every width's
// pieces divide its parts), so each part's descriptor is the tile's moved
// by whole pieces.  D 16, 32, 64 and 128 are one wgmma.
template <int D, int C0 = 0>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const unsigned (&a)[4], unsigned v) {
  using Geo = WgTile<D>;
  constexpr int LEFT = D - C0;
  if constexpr (LEFT > 0) {
    const uint64_t b =
        gmma_desc(v + (C0 / Geo::ROW) * Geo::HALF_BYTES, Geo::HALF_BYTES,
                  Geo::ATOM, Geo::LAYOUT);
    constexpr int N = LEFT >= 128 ? 128 : LEFT >= 64 ? 64 : LEFT >= 32 ? 32
                                                                        : 16;
    static_assert(C0 % Geo::ROW == 0, "a part starts a piece");
    if constexpr (N == 128) wgmma_rs_n128<C0 / 2>(o, a, b);
    else if constexpr (N == 64) wgmma_rs_n64<C0 / 2>(o, a, b);
    else if constexpr (N == 32) wgmma_rs_n32<C0 / 2>(o, a, b);
    else wgmma_rs_n16<C0 / 2>(o, a, b);
    wgmma_pv<D, C0 + N>(o, a, v);
  }
}

// Accumulator layout of m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): element 4j + e holds row 16w + g + 8 (e / 2), column 8j +
// 2t + e % 2, the m16n8 fragments of mma.sync side by side; the register
// A operand of a k16 step is two adjacent n8 fragments, so P stays in
// registers.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS, WgTile<D>::MIN_BLOCKS)
    wg_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
              int S, int H, int rep, int dh, float scale) {
  using Geo = WgTile<D>;
  constexpr int STAGES = Geo::STAGES, HALVES = Geo::HALVES, ROW = Geo::ROW,
                HALF = Geo::HALF_BYTES, TILE = Geo::TILE_BYTES, NO = Geo::NO,
                ATOM = Geo::ATOM;
  constexpr unsigned LAYOUT = Geo::LAYOUT;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const unsigned base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const unsigned q_s = base;
  auto k_s = [&](int st) { return base + (1 + 2 * st) * TILE; };
  auto v_s = [&](int st) { return base + (2 + 2 * st) * TILE; };
  auto full = [&](int st) { return base + Geo::BAR_OFF + 8 * st; };
  auto empty = [&](int st) { return base + Geo::BAR_OFF + 8 * (STAGES + st); };
  const unsigned q_bar = base + Geo::BAR_OFF + 16 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / rep;
  // the last query tiles have the most keys under causal masking: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_kt = (S + BK - 1) / BK;
  // SKIP: under causal masking no key tile past the diagonal is visited
  const int kt_end = CAUSAL ? min(n_kt, q0 / BK + 1) : n_kt;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_bar, TILE);
      for (int hf = 0; hf < HALVES; ++hf)
        tma_box(q_s + hf * HALF, &tq, q_bar, hf * ROW, q0, h, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty(st), (kt / STAGES - 1) & 1);
        mbar_expect_tx(full(st), 2 * TILE);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_box(k_s(st) + hf * HALF, &tk, full(st), hf * ROW, kt * BK,
                  kvh, b);
          tma_box(v_s(st) + hf * HALF, &tv, full(st), hf * ROW, kt * BK,
                  kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: per key tile, S = Q K^T, the softmax on its
  // fragments, O rescaled, P packed, O += P V
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float o[NO], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float corr[2];
  unsigned pa[4][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // S = Q K^T, both K-major: a k16 step is 32 bytes along a row
  auto issue_s = [&](int kt) {
    const int st = kt % STAGES;
    mbar_wait(full(st), (kt / STAGES) & 1);
    // the first step overwrites s; zeroing it ends the last tile's values'
    // live range, which the register budget of 4 blocks per SM needs
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned off = (kk / (ROW / 16)) * HALF + (kk % (ROW / 16)) * 32;
      wgmma_ss_n64(s, gmma_desc(q_s + off, 16, ATOM, LAYOUT),
                   gmma_desc(k_s(st) + off, 16, ATOM, LAYOUT), kk > 0);
    }
    wg_commit();
  };
  // O += P V: V MN-major, a k16 step is 16 rows, the two halves of D 128
  // are HALF bytes apart
  auto issue_pv = [&](int kt) {
    const int st = kt % STAGES;
    pin(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(o, pa[kk], v_s(st) + kk * 16 * Geo::ROW_BYTES);
    wg_commit();
  };
  // scores in f32 times 1/sqrt(D), masked only in the diagonal tile
  // (causal) and the ragged last tile; p = exp(x - m) in s, as 2^(x log2 e
  // - m log2 e): one FFMA and one ex2; l over the unrounded p
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    const bool edge = (CAUSAL && kt == kt_end - 1) || k0 + BK > S;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (edge) {
        const int kp = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int qp = row0 + ((i >> 1) & 1) * 8;
        if (kp >= S || (CAUSAL && kp > qp)) x = NEG_INF;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      ml[r] = m_new * LOG2E;
      corr[r] = ex2(fmaf(m[r], LOG2E, -ml[r]));
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], LOG2E, -ml[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += p;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
  };
  // O *= corr; P rounded to bf16
  auto rescale_pack = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < kt_end; ++kt) {
    issue_s(kt);
    wg_wait<0>();
    pin(s);
    softmax(kt);
    rescale_pack();
    issue_pv(kt);
    wg_wait<0>();
    pin(o);
    pin(pa);  // the registers the PV product read stay untouched till here
    mbar_arrive(empty(kt % STAGES));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + r * 8;
    if (qp >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = out + (((size_t)b * S + qp) * H + h) * dh + 2 * t;
    if (dh == D) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    } else {  // a head narrower than the kernel: its columns only
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 8 + 2 * t + e < dh)
            orow[j * 8 + e] = o[4 * j + 2 * r + e] / den;
    }
  }
}

// ---------------------------------------------------------------------
struct Args {
  const void *q, *k, *v;
  float* out;
  int B, S, H, KV, D;  // D: the heads' own width, at most the kernel's
  Strides qs, ks, vs;
  cudaStream_t s;
};

// above 48 KB of shared memory only after opting in, once per kernel
template <auto Kernel>
cudaError_t opt_in(size_t smem) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) done = true;
  return e;
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links only the CUDA runtime
using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// TMA map of a (B, S, heads, dh) bf16 view read through its strides, in
// boxes of 64 rows by one stored row of the kernel's width D, with the
// tile's swizzle; rows past S and columns past dh read as zeros
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, int S, int heads, int B,
                int dh, const Strides& st) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)WgTile<D>::ROW, BK, 1, 1},
                   elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            WgTile<D>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAUSAL>
cudaError_t launch_fma(const Args& x, float scale) {
  constexpr size_t smem = FmaTile<D>::SMEM;
  const cudaError_t e = opt_in<fma_kernel<D, CAUSAL>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(x.B * x.H, (x.S + BQ - 1) / BQ);
  fma_kernel<D, CAUSAL><<<grid, FMA_THREADS, smem, x.s>>>(
      static_cast<const float*>(x.q), static_cast<const float*>(x.k),
      static_cast<const float*>(x.v), x.out, x.S, x.H, x.H / x.KV, x.D,
      x.qs, x.ks, x.vs, scale);
  return cudaGetLastError();
}

// the maps are built per call and passed by value (__grid_constant__), so
// a CUDA graph that captured the launch replays it with its own maps
template <int D, bool CAUSAL>
cudaError_t launch_wg(const Args& x, float scale) {
  constexpr size_t smem = WgTile<D>::SMEM;
  const cudaError_t e = opt_in<wg_kernel<D, CAUSAL>>(smem);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv;
  if (!tensor_map<D>(&mq, x.q, x.S, x.H, x.B, x.D, x.qs) ||
      !tensor_map<D>(&mk, x.k, x.S, x.KV, x.B, x.D, x.ks) ||
      !tensor_map<D>(&mv, x.v, x.S, x.KV, x.B, x.D, x.vs))
    return cudaErrorInvalidValue;
  const dim3 grid(x.B * x.H, (x.S + BQ - 1) / BQ);
  wg_kernel<D, CAUSAL><<<grid, WG_THREADS, smem, x.s>>>(
      mq, mk, mv, x.out, x.S, x.H, x.H / x.KV, x.D, scale);
  return cudaGetLastError();
}

// the kernel of width D for heads of x.D <= D columns; the scale is the
// heads' own, 1 / sqrt(x.D)
template <int D>
cudaError_t launch_d(const Args& x, int causal, int bf16) {
  const float scale = (float)(1.0 / sqrt((double)x.D));
  if (bf16)
    return causal ? launch_wg<D, true>(x, scale)
                  : launch_wg<D, false>(x, scale);
  if constexpr (D == 80) return cudaErrorInvalidValue;  // by_width: f32 96
  else
    return causal ? launch_fma<D, true>(x, scale)
                  : launch_fma<D, false>(x, scale);
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

template <auto Kernel>
cudaError_t kernel_info(size_t smem, int threads, int* info) {
  cudaError_t e = opt_in<Kernel>(smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, Kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)smem;
  info[4] = blocks;
  return cudaSuccess;
}

template <int D, bool CAUSAL>
cudaError_t info_d(int bf16, int* info) {
  info[0] = bf16;
  if (bf16)
    return kernel_info<wg_kernel<D, CAUSAL>>(WgTile<D>::SMEM, WG_THREADS,
                                             info);
  if constexpr (D == 80) return cudaErrorInvalidValue;  // by_width: f32 96
  else
    return kernel_info<fma_kernel<D, CAUSAL>>(FmaTile<D>::SMEM, FMA_THREADS,
                                              info);
}

template <int D>
cudaError_t info_causal(int bf16, int causal, int* info) {
  info[5] = D;
  return causal ? info_d<D, true>(bf16, info) : info_d<D, false>(bf16, info);
}

// The widths the library holds, and the one a head dim of 1 to 256 runs:
// the first at least as wide, its missing columns read as zeros.  f32
// skips 80 (heads of 65 to 96 run 96): there the compiler spilled the
// causal FMA kernel's registers to keep four blocks on an SM.  Calls f
// with the width as a compile-time constant; cudaErrorInvalidValue for
// any other head dim.
template <typename F>
cudaError_t by_width(int D, int bf16, F f) {
  using std::integral_constant;
  if (D < 1 || D > 256) return cudaErrorInvalidValue;
  if (D <= 16) return f(integral_constant<int, 16>{});
  if (D <= 32) return f(integral_constant<int, 32>{});
  if (D <= 48) return f(integral_constant<int, 48>{});
  if (D <= 64) return f(integral_constant<int, 64>{});
  if (D <= 80 && bf16) return f(integral_constant<int, 80>{});
  if (D <= 96) return f(integral_constant<int, 96>{});
  if (D <= 112) return f(integral_constant<int, 112>{});
  if (D <= 128) return f(integral_constant<int, 128>{});
  if (D <= 160) return f(integral_constant<int, 160>{});
  if (D <= 192) return f(integral_constant<int, 192>{});
  return f(integral_constant<int, 256>{});
}

}  // namespace

// What serves (D, bf16, causal), in info[0..5]: the variant (1 = bf16
// wgmma with the TMA ring, wg_kernel; 0 = f32 FMA, fma_kernel),
// registers per thread, local memory per thread in bytes (spills and
// stack), dynamic shared memory per block in bytes, resident blocks per
// SM, and the kernel's width (by_width).  D outside 1 to 256 returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_info(int D, int bf16, int causal, int* info) {
  return by_width(D, bf16, [&](auto w) {
    return info_causal<decltype(w)::value>(bf16, causal, info);
  });
}

// Plain C interface (ctypes).  Pointers are device pointers, the stream a
// cudaStream_t, strides in elements with the last dimension contiguous;
// out is a contiguous (B, S, H, D) f32 tensor.  D from 1 to 256 (by_width)
// and H a multiple of KV; any other shape returns cudaErrorInvalidValue.  bf16
// inputs are copied 16 bytes at a time: their pointers must be 16-byte
// aligned and their strides multiples of 8 elements, else
// cudaErrorMisalignedAddress.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int D,
                               long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh,
                               int causal, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV ||
      (long long)(S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const Args x{q, k, v, static_cast<float*>(out), B, S, H, KV, D,
               Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
               Strides{vsb, vss, vsh}, static_cast<cudaStream_t>(stream)};
  if (bf16 && !(aligned16(q, x.qs) && aligned16(k, x.ks) &&
                aligned16(v, x.vs)))
    return cudaErrorMisalignedAddress;
  return by_width(D, bf16, [&](auto w) {
    return launch_d<decltype(w)::value>(x, causal, bf16);
  });
}
