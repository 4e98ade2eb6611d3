// Block-sparse matmuls for Hopper (sm_90a): the paper's SKIP vs GATE
// taxonomy as two kernels.  Both compute out (M, N) f32 = A (M, K) @ W
// (K, N) summed over the (k, j) blocks of W (bk x bn) that a block list or
// a mask names; A and W are f32 or bf16, row-major, contiguous.
//
// K1 SKIP replaces the JAX package's kernels/block_mm/kernel.py:
//   skip_mm_kernel / _skip_kernel (pl.pallas_call at :113).  There the
//   grid was (M/bm, nnzb) over the nonzero blocks sorted by j, with an f32
//   VMEM accumulator carried across the consecutive grid steps of one
//   column.  Here column block j's run of the sorted list, kidx[colptr[j]
//   .. colptr[j+1]) (column pointers built by the wrapper), is walked by
//   the thread blocks of its output tiles; empty W blocks are never read,
//   so SKIP saves the bytes and the time.
//
// K2 GATE replaces kernels/block_mm/kernel.py: gated_mm_kernel /
//   _gated_kernel (pl.pallas_call at :64), the full (M/bm, N/bn, K/bk)
//   grid with the dot predicated by block_mask[k, j].  Here every output
//   tile walks every k block.  The A and W tiles of EVERY k block are
//   copied into shared memory whatever the mask says; only the products
//   (FMAs, or ldmatrix + mma.sync) sit under the mask, which is uniform per
//   thread block and k block.  If the copies went under the branch, GATE
//   would turn into SKIP (it would stop paying for the bytes of the masked
//   blocks) and the gate-time agreement arm (fleet/validate.py) would
//   measure the wrong mechanism.
//
// What bounds them (published rates of an H100 SXM at 700 W: 3.35 TB/s,
// 67 TFLOP/s f32 FMA, 989 TFLOP/s bf16 tensor cores, 132 SMs), at blocks of
// 64 and density 0.25 (every column keeps its first k block):
//   ffn_gate_up (8, 896, 9728) f32: W 34.9 MB, 10.4 us, for GATE and for
//     SKIP on the full list; SKIP on the nonzero list ~30% of it.  Each W
//     element is used 8 times: 4 FLOP a byte, far under the ~20 the f32
//     rate needs.  Bytes, but 152 column tiles of one block each walking
//     all of K were 1.15 waves with a few KB in flight per SM: latency.
//   lm_head (8, 896, 151936) f32: W 545 MB, 163 us; 2374 column tiles
//     fill the card.  Bytes.
//   ffn_down (128, 4864, 896) bf16: W 8.7 MB, A 1.2 MB, 3.1 us; 1.1 GFLOP
//     of products (GATE predicates 3/4 of them off), 1.1 us at the
//     tensor-core peak.  Bytes, but 28 tiles of 64 x 64 filled a fifth of
//     the card, and f32 FMAs on widened bf16 made it compute-bound.
//
// What the design does about it.  Two paths, picked by the wrapper's plan
// (kernels/block_mm/ops.py plan(), passed in as the kernel, the tile
// columns, the K split and the slice cap; the C side checks them):
//
// 1. narrow (f32 at any M; bf16 at M <= 32, or with bk not a multiple of
//    32 or bn not of 32; CUDA cores, f32 FMAs, no TF32).  A thread block
//    of 128 threads owns 8 output rows by TN columns (64, 32 or 16: the
//    widest that divides bn); rows past M (a decode at batch 1 to 7) read
//    A as zeros and are not written.  A 4-stage cp.async ring brings 32 k
//    rows a stage: A's 8 x 32 and W's 32 x TN, 16 bytes a copy.  Each
//    thread owns 4 columns and all 8 rows of a lane of consecutive k rows
//    (4 at TN = 64 in f32): per k row 32 FMAs on one 16-byte W read and A
//    read 16 bytes at a time per row.  The lanes are summed by warp
//    shuffles, then over the 4 warps in order through shared memory.
//    Blocks of 8 to 24 k rows, or any bk that 32 does not divide (FRAG),
//    are laid end to end: a stage holds the next 32 rows of its slice,
//    parts of one block or several, each 16-byte copy inside one block
//    (bk % 8 == 0), and the slice's last stage is zero-filled past its
//    end.
// 2. wide (bf16 at M > 32, bk % 32 == 0, bn % 32 == 0; tensor cores).  A
//    block has a warp per 32 x 32 of its 128 x TN output tile (rows past
//    M are zero-filled on the copy and not written, so one tile height
//    serves every M); the same
//    4-stage ring of 32-row stages, rows padded by 16 bytes so that
//    ldmatrix rows fall on distinct banks; mma.sync m16n8k16 with A by
//    ldmatrix and the row-major W (MN-major for B) by ldmatrix.trans, f32
//    accumulators in registers.  mma.sync and not wgmma: the products are
//    a third of the byte bound even at mma.sync's rate, and the 32 x 32
//    warp tiles need no descriptor layouts or asynchronous fences.
//
// Both paths split K: the k blocks of a column (its run for SKIP, all
// K/bk for GATE) are cut into split contiguous slices of whole blocks
// (slice s: [len*s/split, len*(s+1)/split)); a slice with no blocks adds
// zeros.  The plan picks split, a power of two up to 16, to put about 2
// waves of blocks on the card's SMs, and never more slices than the
// longest run has blocks.  The slices of one output tile are one
// thread-block cluster (past the portable 8 by opting in): each block
// leaves its partial tile in its shared memory, and after a cluster
// barrier block q sums the q-th share of the tile over the ranks in the
// fixed order 0, 1, ..., split-1 through distributed shared memory and
// writes it: one launch, no atomics, the same bits on every call.  A
// block first brings its slice's k-block indices (SKIP) or mask flags
// (GATE) into shared memory, at most `cap` of them (the plan's longest
// slice); GATE issues its first copies before reading the mask.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SPLIT = 16;  // a cluster, past the portable 8
constexpr int KC = 32;         // k rows per ring stage; bk is a multiple
constexpr int NSTAGES = 4;     // cp.async ring depth
// the largest dynamic shared memory a block may ask for (opted in once)
constexpr int MAX_SMEM = 227 * 1024;

// cp.async of 16 bytes; with !valid nothing is read and the destination is
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The partial tiles of one cluster (one per K-slice, `elems` floats each
// at `red` in every block's shared memory) summed in rank order: block q
// writes the q-th share of the tile through `store(e4, sum)`, e4 indexing
// float4s.  Returns after every rank has read every partial.
template <typename Store>
__device__ __forceinline__ void cluster_reduce(float* red, int elems,
                                               int threads, Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  const int e4 = elems / 4;
  const int lo = rank * e4 / split, hi = (rank + 1) * e4 / split;
  for (int e = lo + (int)threadIdx.x; e < hi; e += threads) {
    float4 p[MAX_SPLIT];  // every rank's loads in flight at once
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split)
        p[q] = *cluster.map_shared_rank(reinterpret_cast<float4*>(red) + e, q);
    float4 sum = p[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        sum.x += p[q].x;
        sum.y += p[q].y;
        sum.z += p[q].z;
        sum.w += p[q].w;
      }
    store(e, sum);
  }
  cluster.sync();
}

// This block's K-slice: the k blocks it sums are entries lo .. lo+n of its
// column's list (SKIP: kidx[lo + i]; GATE: k block lo + i, flag
// mask[(lo + i) * nbn + j]), staged in `ks` (shared memory, cap ints).
// Thread blocks along x are (column tile, rank) with the rank fastest, so
// that the split ranks of one tile are one cluster.
template <bool GATE>
struct Slice {
  int lo, n, j, nbn, sub;

  __device__ __forceinline__ Slice(const int* __restrict__ colptr, int col0,
                                   int K, int N, int bk, int bn, int split) {
    const int rank = (int)blockIdx.x % split;
    j = col0 / bn;
    nbn = N / bn;
    sub = bk / KC;
    int begin = 0, len = K / bk;
    if constexpr (!GATE) {
      begin = colptr[j];
      len = colptr[j + 1] - begin;
    }
    lo = begin + (int)((long long)len * rank / split);
    n = begin + (int)((long long)len * (rank + 1) / split) - lo;
  }

  // SKIP: the slice's k-block indices into ks; GATE: its mask flags.
  // Trap on a slice longer than the plan's cap: the wrapper computes both
  // from one block list, so only a wrong caller of the C interface can.
  __device__ __forceinline__ void stage(const int* __restrict__ idx, int* ks,
                                        int cap, int threads) const {
    if (n > cap) __trap();
    for (int i = (int)threadIdx.x; i < n; i += threads)
      ks[i] = GATE ? idx[(size_t)(lo + i) * nbn + j] != 0 : idx[lo + i];
  }

  // the first k row of ring step st (a KC-row stage of a k block)
  __device__ __forceinline__ int k0(const int* ks, int bk, int st) const {
    const int e = st / sub;
    return (GATE ? lo + e : ks[e]) * bk + (st - e * sub) * KC;
  }

  // GATE: whether step st's products count (uniform over the block)
  __device__ __forceinline__ bool on(const int* ks, int st) const {
    return !GATE || ks[st / sub] != 0;
  }

  // Blocks shorter than a stage (bk % KC != 0): the slice's blocks laid
  // end to end as n * bk virtual rows, a stage KC of them.  The k row of
  // virtual row v < n * bk:
  __device__ __forceinline__ int krow(const int* ks, int bk, int v) const {
    const int e = v / bk;
    return (GATE ? lo + e : ks[e]) * bk + (v - e * bk);
  }
  // GATE: whether virtual row v's products count (v past the slice: no)
  __device__ __forceinline__ bool on_row(const int* ks, int bk, int v) const {
    return !GATE || (v < n * bk && ks[v / bk] != 0);
  }
};

// The ring: `steps` stages of copies issued NSTAGES - 1 ahead of the
// products.  `staged` runs once the first copies are in flight (GATE reads
// its mask there).  Returns with every copy landed and every thread past
// its last products, so the ring's memory is free.
template <typename Load, typename Staged, typename Compute>
__device__ __forceinline__ void run_ring(int steps, Load load, Staged staged,
                                         Compute compute) {
#pragma unroll
  for (int st = 0; st < NSTAGES - 1; ++st) {
    if (st < steps) load(st);
    cp_commit();
  }
  staged();
  for (int st = 0; st < steps; ++st) {
    cp_wait<NSTAGES - 2>();  // step st's copies (this thread's) are in
    __syncthreads();  // ... everyone's, and everyone is done with st - 1
    if (st + NSTAGES - 1 < steps) load(st + NSTAGES - 1);
    cp_commit();
    compute(st);
  }
  cp_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------
// narrow path: CUDA cores, 8 output rows a block
constexpr int NR = 8;    // output rows per block
constexpr int NT = 128;  // threads per block

template <typename T, int TN>
struct Narrow {
  static constexpr int G = TN / 4;   // groups of 4 output columns
  static constexpr int Q = NT / G;   // k lanes
  static constexpr int R = KC / Q;   // consecutive k rows per lane per stage
  static constexpr int A_BYTES = NR * KC * (int)sizeof(T);
  static constexpr int W_BYTES = KC * TN * (int)sizeof(T);
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int SMEM = NSTAGES * STAGE;  // without the slice's ks
  static constexpr int A_CH = A_BYTES / 16;     // 16-byte copies a stage
  static constexpr int W_CH = W_BYTES / 16;
  static_assert(KC % Q == 0 && (R == 1 || R == 2 || R == 4), "k lanes");
  static_assert(A_CH <= NT && (W_CH % NT == 0 || W_CH < NT),
                "copies spread evenly");
  static_assert(4 * NR * TN * 4 <= SMEM, "warp partials reuse the ring");
};

// R consecutive values at p as floats
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}
__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
template <int R>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[R]) {
  if constexpr (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(v.x), x[1] = bf_hi(v.x), x[2] = bf_lo(v.y),
    x[3] = bf_hi(v.y);
  } else if constexpr (R == 2) {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    x[0] = bf_lo(v), x[1] = bf_hi(v);
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// grid (split * N / TN, ceil(M / 8)), clusters of (split, 1, 1); rows
// past M read A as zeros and are not written.  FRAG: blocks shorter than
// a stage (bk % KC != 0, bk a multiple of 8), a stage holding the next KC
// of the slice's rows laid end to end (Slice::krow); a lane's R rows lie
// in one block, so GATE's predicate is per lane there.
template <typename T, int TN, bool GATE, bool FRAG>
__global__ void __launch_bounds__(NT)
narrow_kernel(const T* __restrict__ a, const T* __restrict__ w,
              const int* __restrict__ idx, const int* __restrict__ colptr,
              float* __restrict__ out, int M, int K, int N, int bk, int bn,
              int split, int cap) {
  using P = Narrow<T, TN>;
  constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  int* ks = reinterpret_cast<int*>(smem + P::SMEM);
  const int tid = threadIdx.x;
  const int col0 = ((int)blockIdx.x / split) * TN, row0 = blockIdx.y * NR;
  const Slice<GATE> sl(colptr, col0, K, N, bk, bn, split);
  if constexpr (!GATE) {  // the copies' addresses need the indices
    sl.stage(idx, ks, cap, NT);
    __syncthreads();
  }

  auto load = [&](int st) {
    unsigned char* base = smem + (st % NSTAGES) * P::STAGE;
    T* As = reinterpret_cast<T*>(base);
    T* Ws = reinterpret_cast<T*>(base + P::A_BYTES);
    // FRAG: virtual rows v0 .. v0 + KC, zeros past the slice's end
    const int k0 = FRAG ? 0 : sl.k0(ks, bk, st);
    const int v0 = st * KC, vend = FRAG ? sl.n * bk : 0;
    if (tid < P::A_CH) {
      const int r = tid / (KC / VE), c = (tid % (KC / VE)) * VE;
      const bool ok = row0 + r < M && (!FRAG || v0 + c < vend);
      const int k = FRAG ? (ok ? sl.krow(ks, bk, v0 + c) : 0) : k0 + c;
      cp_async16(As + r * KC + c, ok ? a + (size_t)(row0 + r) * K + k : a, ok);
    }
#pragma unroll
    for (int q = 0; q < (P::W_CH + NT - 1) / NT; ++q) {
      const int e = tid + q * NT;
      if (P::W_CH % NT == 0 || e < P::W_CH) {
        const int r = e / (TN / VE), c = (e % (TN / VE)) * VE;
        if constexpr (FRAG) {
          const bool ok = v0 + r < vend;
          cp_async16(Ws + r * TN + c,
                     ok ? w + (size_t)sl.krow(ks, bk, v0 + r) * N + col0 + c
                        : w,
                     ok);
        } else {
          cp_async16(Ws + r * TN + c, w + (size_t)(k0 + r) * N + col0 + c);
        }
      }
    }
  };

  // thread (q, g): columns g*4 .. g*4+3, all 8 rows, k rows q*R .. q*R+R-1
  const int g = tid % P::G, q = tid / P::G;
  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  auto compute = [&](int st) {
    // GATE: the copies were made all the same
    if (FRAG ? !sl.on_row(ks, bk, st * KC + q * P::R) : !sl.on(ks, st))
      return;
    const unsigned char* base = smem + (st % NSTAGES) * P::STAGE;
    const T* As = reinterpret_cast<const T*>(base);
    const T* Ws = reinterpret_cast<const T*>(base + P::A_BYTES);
    float x[NR][P::R];
#pragma unroll
    for (int r = 0; r < NR; ++r) load_row<P::R>(As + r * KC + q * P::R, x[r]);
#pragma unroll
    for (int i = 0; i < P::R; ++i) {
      float v[4];
      load_row<4>(Ws + (q * P::R + i) * TN + g * 4, v);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[r][i], v[c], acc[r][c]);
    }
  };

  run_ring(
      FRAG ? (sl.n * bk + KC - 1) / KC : sl.n * sl.sub, load,
      [&] {
        if constexpr (GATE) sl.stage(idx, ks, cap, NT);
      },
      compute);

  // the k lanes summed: inside each warp by shuffles (lane = q*G + g mod
  // 32), then the 4 warps in order through shared memory
#pragma unroll
  for (int off = P::G; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  float* red = reinterpret_cast<float*>(smem);  // [4 warps][NR][TN]
  const int warp = tid / 32;
  if (tid % 32 < P::G)
#pragma unroll
    for (int r = 0; r < NR; ++r)
      *reinterpret_cast<float4*>(red + (warp * NR + r) * TN + g * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  constexpr int TILE4 = NR * TN / 4;
  float4* red4 = reinterpret_cast<float4*>(red);
  for (int e = tid; e < TILE4; e += NT) {
    float4 s = red4[e];
#pragma unroll
    for (int v = 1; v < NT / 32; ++v) {
      const float4 p = red4[v * TILE4 + e];
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    if (split > 1)
      red4[e] = s;  // the block's partial tile, [NR][TN]
    else if (row0 + e / (TN / 4) < M)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + e / (TN / 4)) * N +
                                 col0 + (e % (TN / 4)) * 4) = s;
  }
  if (split == 1) return;
  cluster_reduce(red, NR * TN, NT, [&](int e4, float4 sum) {
    if (row0 + e4 / (TN / 4) < M)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + e4 / (TN / 4)) * N +
                                 col0 + (e4 % (TN / 4)) * 4) = sum;
  });
}

// ---------------------------------------------------------------------
// wide path: bf16 on the tensor cores, BM x TN output tiles
template <int TN>
struct Wide {
  static constexpr int BM = 128;
  static constexpr int THREADS = (BM / 32) * (TN / 32) * 32;  // warp/32x32
  static constexpr int AS = KC + 8;  // row strides padded by 16 bytes:
  static constexpr int WS = TN + 8;  // ldmatrix rows on distinct banks
  static constexpr int A_BYTES = BM * AS * 2;
  static constexpr int W_BYTES = KC * WS * 2;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int SMEM = NSTAGES * STAGE;  // without the slice's ks
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
  static_assert(BM * TN * 4 <= SMEM, "the partial tile reuses the ring");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (split * N / TN, ceil(M / BM)), clusters of (split, 1, 1)
template <int TN, bool GATE>
__global__ void __launch_bounds__(Wide<TN>::THREADS)
wide_kernel(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ w, const int* __restrict__ idx,
            const int* __restrict__ colptr, float* __restrict__ out, int M,
            int K, int N, int bk, int bn, int split, int cap) {
  using P = Wide<TN>;
  using bf16 = __nv_bfloat16;
  constexpr int BM = P::BM, WT = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  int* ks = reinterpret_cast<int*>(smem + P::SMEM);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = ((int)blockIdx.x / split) * TN, row0 = blockIdx.y * BM;
  const Slice<GATE> sl(colptr, col0, K, N, bk, bn, split);
  if constexpr (!GATE) {
    sl.stage(idx, ks, cap, WT);
    __syncthreads();
  }

  // step st's A tile (rows past M read as zeros) and W tile into its slot
  auto load = [&](int st) {
    unsigned char* base = smem + (st % NSTAGES) * P::STAGE;
    bf16* As = reinterpret_cast<bf16*>(base);
    bf16* Ws = reinterpret_cast<bf16*>(base + P::A_BYTES);
    const int k0 = sl.k0(ks, bk, st);
#pragma unroll
    for (int q = 0; q < BM * KC / 8 / WT; ++q) {
      const int e = tid + q * WT;
      const int r = e / (KC / 8), c = (e % (KC / 8)) * 8;
      const bool ok = row0 + r < M;
      cp_async16(As + r * P::AS + c,
                 ok ? a + (size_t)(row0 + r) * K + k0 + c : a, ok);
    }
#pragma unroll
    for (int q = 0; q < KC * TN / 8 / WT; ++q) {
      const int e = tid + q * WT;
      const int r = e / (TN / 8), c = (e % (TN / 8)) * 8;
      cp_async16(Ws + r * P::WS + c, w + (size_t)(k0 + r) * N + col0 + c);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;
  const int wm = warp / (TN / 32), wn = warp % (TN / 32);

  auto compute = [&](int st) {
    if (!sl.on(ks, st)) return;  // GATE: the copies were made all the same
    const unsigned char* base = smem + (st % NSTAGES) * P::STAGE;
    const bf16* As = reinterpret_cast<const bf16*>(base);
    const bf16* Ws = reinterpret_cast<const bf16*>(base + P::A_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      unsigned af[2][4], bt[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], As + (wm * 32 + i * 16 + (lane & 15)) * P::AS +
                               kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bt[j],
                          Ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   P::WS +
                              wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bt[j / 2][(j % 2) * 2],
                   bt[j / 2][(j % 2) * 2 + 1]);
    }
  };

  run_ring(
      sl.n * sl.sub, load,
      [&] {
        if constexpr (GATE) sl.stage(idx, ks, cap, WT);
      },
      compute);

  // this thread's accumulators: rows wm*32 + i*16 + lane/4 (+ 8), columns
  // wn*32 + j*8 + (lane%4)*2 (+ 1)
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
          const int c = col0 + wn * 32 + j * 8 + (lane & 3) * 2;
          if (r < M)
            *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }
  float* red = reinterpret_cast<float*>(smem);  // [BM][TN]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + (lane >> 2) + h * 8;
        const int c = wn * 32 + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(red + r * TN + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cluster_reduce(red, BM * TN, WT, [&](int e4, float4 sum) {
    const int r = row0 + e4 / (TN / 4), c = col0 + (e4 % (TN / 4)) * 4;
    if (r < M) *reinterpret_cast<float4*>(out + (size_t)r * N + c) = sum;
  });
}

// ---------------------------------------------------------------------
struct Args {
  const void* a;
  const void* w;
  const int* idx;     // SKIP: kidx; GATE: the mask (K/bk, N/bn)
  const int* colptr;  // SKIP only
  float* out;
  int M, K, N, bk, bn, split, cap;
  cudaStream_t s;
};

// above 48 KB of shared memory, and clusters above 8 blocks, only after
// opting in, once per kernel
template <auto Kernel>
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done = true;
  return e;
}

// one launch; the split K-slices of an output tile form one cluster
template <auto Kernel, typename... Ts>
cudaError_t launch(const Args& x, dim3 grid, int threads, size_t smem,
                   Ts... args) {
  cudaError_t e = opt_in<Kernel>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = x.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = x.s;
  cfg.attrs = attr;
  cfg.numAttrs = x.split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int TN, bool GATE, bool FRAG>
cudaError_t launch_narrow(const Args& x) {
  using P = Narrow<T, TN>;
  const dim3 grid(x.split * (x.N / TN), (x.M + NR - 1) / NR);
  return launch<narrow_kernel<T, TN, GATE, FRAG>>(
      x, grid, NT, P::SMEM + 4 * (size_t)x.cap, static_cast<const T*>(x.a),
      static_cast<const T*>(x.w), x.idx, x.colptr, x.out, x.M, x.K, x.N,
      x.bk, x.bn, x.split, x.cap);
}

template <typename T, int TN, bool GATE>
cudaError_t launch_narrow_bk(const Args& x) {
  return x.bk % KC ? launch_narrow<T, TN, GATE, true>(x)
                   : launch_narrow<T, TN, GATE, false>(x);
}

template <int TN, bool GATE>
cudaError_t launch_wide(const Args& x) {
  using P = Wide<TN>;
  const dim3 grid(x.split * (x.N / TN), (x.M + P::BM - 1) / P::BM);
  return launch<wide_kernel<TN, GATE>>(
      x, grid, P::THREADS, P::SMEM + 4 * (size_t)x.cap,
      static_cast<const __nv_bfloat16*>(x.a),
      static_cast<const __nv_bfloat16*>(x.w), x.idx, x.colptr, x.out, x.M,
      x.K, x.N, x.bk, x.bn, x.split, x.cap);
}

// kernel 0 = narrow (f32 or bf16), 1 = wide (bf16, tn 32 or 64); tile
// columns tn = 16, 32 or 64
template <bool GATE, int TN>
cudaError_t launch_tn(const Args& x, int kernel, int bf16) {
  if constexpr (TN >= 32)
    if (kernel == 1) return launch_wide<TN, GATE>(x);
  return bf16 ? launch_narrow_bk<__nv_bfloat16, TN, GATE>(x)
              : launch_narrow_bk<float, TN, GATE>(x);
}

template <bool GATE>
cudaError_t launch_block_mm(const Args& x, int bf16, int kernel, int tn) {
  const long long nbk = x.K / (x.bk > 0 ? x.bk : 1);
  if (x.M <= 0 || x.bk <= 0 || x.bk % 8 || x.K <= 0 || x.K % x.bk ||
      x.bn <= 0 || x.bn % 16 || x.N <= 0 || x.N % x.bn ||
      (tn != 16 && tn != 32 && tn != 64) || x.bn % tn || x.split < 1 ||
      x.split > MAX_SPLIT || x.cap < 1 || kernel < 0 || kernel > 1 ||
      (kernel && (!bf16 ||  // f32 never on TF32
                  x.bk % KC || tn < 32)) ||
      (long long)x.split * (x.N / tn) > 0x7fffffffLL ||
      (x.M + NR - 1) / NR > 65535 || 4LL * x.cap > 128 * 1024 ||
      (GATE && (long long)x.split * x.cap < nbk))
    return cudaErrorInvalidValue;
  for (const void* p : {x.a, x.w, static_cast<const void*>(x.out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  return tn == 64   ? launch_tn<GATE, 64>(x, kernel, bf16)
         : tn == 32 ? launch_tn<GATE, 32>(x, kernel, bf16)
                    : launch_tn<GATE, 16>(x, kernel, bf16);
}

template <auto Kernel>
cudaError_t kernel_info(size_t smem, int threads, int* info) {
  cudaError_t e = opt_in<Kernel>();
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, Kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  info[0] = KC;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)smem;
  info[4] = blocks;
  info[5] = threads;
  return cudaSuccess;
}

template <bool GATE, int TN, bool FRAG>
cudaError_t info_tn(int kernel, int bf16, int* info) {
  if constexpr (TN >= 32 && !FRAG)
    if (kernel == 1)
      return kernel_info<wide_kernel<TN, GATE>>(Wide<TN>::SMEM,
                                                Wide<TN>::THREADS, info);
  if (bf16)
    return kernel_info<narrow_kernel<__nv_bfloat16, TN, GATE, FRAG>>(
        Narrow<__nv_bfloat16, TN>::SMEM, NT, info);
  return kernel_info<narrow_kernel<float, TN, GATE, FRAG>>(
      Narrow<float, TN>::SMEM, NT, info);
}

template <bool GATE, bool FRAG>
cudaError_t info_frag(int kernel, int tn, int bf16, int* info) {
  return tn == 64   ? info_tn<GATE, 64, FRAG>(kernel, bf16, info)
         : tn == 32 ? info_tn<GATE, 32, FRAG>(kernel, bf16, info)
                    : info_tn<GATE, 16, FRAG>(kernel, bf16, info);
}

}  // namespace

// What serves (kernel, tn, bf16, gate, frag), in info[0..5]: k rows per
// ring stage, registers per thread, local memory per thread in bytes
// (spills and stack), dynamic shared memory per block in bytes (the ring;
// a launch adds 4 bytes per slice entry), resident blocks per SM at that
// shared memory, threads per block.  kernel 0 = narrow (CUDA cores), 1 =
// wide (bf16 tensor cores, 128-row tiles, tn 32 or 64, not frag); tn =
// 16, 32 or 64 tile columns; frag: blocks shorter than a stage (bk % 32
// != 0).  Returns cudaErrorInvalidValue for a variant the library does
// not hold.
extern "C" int block_mm_info(int kernel, int tn, int bf16, int gate,
                             int frag, int* info) {
  if (kernel < 0 || kernel > 1 || (kernel && (!bf16 || tn < 32 || frag)) ||
      (tn != 16 && tn != 32 && tn != 64))
    return cudaErrorInvalidValue;
  if (gate)
    return frag ? info_frag<true, true>(kernel, tn, bf16, info)
                : info_frag<true, false>(kernel, tn, bf16, info);
  return frag ? info_frag<false, true>(kernel, tn, bf16, info)
              : info_frag<false, false>(kernel, tn, bf16, info);
}

// Plain C interface (ctypes).  Pointers are device pointers; a, w and out
// 16-byte aligned (else cudaErrorMisalignedAddress); the stream is a
// cudaStream_t.  The plan: kernel (0 narrow; 1 wide, bf16 only, bk a
// multiple of 32 and tn 32 or 64), tn tile columns (16, 32 or 64,
// dividing bn), split K-slices (1..16) and cap, the most k blocks any
// slice holds.  Shapes: any M >= 1, bk a multiple of 8 dividing K, bn a
// multiple of 16 dividing N (so every row of A and W starts 16-byte
// aligned).  Anything else returns cudaErrorInvalidValue; otherwise the
// launch's cudaError_t (0 on success).
//
// K1 SKIP: kidx (nnzb,) int32 sorted by column block, colptr (N/bn + 1,)
// int32 with column block j's run at colptr[j] .. colptr[j+1].  A slice
// longer than cap traps the kernel.
extern "C" int block_mm_skip(const void* a, const void* w, const void* kidx,
                             const void* colptr, void* out, int M, int K,
                             int N, int bk, int bn, int bf16, int kernel,
                             int tn, int split, int cap, void* stream) {
  const Args x{a, w, static_cast<const int*>(kidx),
               static_cast<const int*>(colptr), static_cast<float*>(out),
               M, K, N, bk, bn, split, cap, static_cast<cudaStream_t>(stream)};
  return launch_block_mm<false>(x, bf16, kernel, tn);
}

// K2 GATE: mask (K/bk, N/bn) int32, nonzero where a block counts; split *
// cap must cover K/bk.
extern "C" int block_mm_gated(const void* a, const void* w, const void* mask,
                              void* out, int M, int K, int N, int bk, int bn,
                              int bf16, int kernel, int tn, int split,
                              int cap, void* stream) {
  const Args x{a, w, static_cast<const int*>(mask), nullptr,
               static_cast<float*>(out), M, K, N, bk, bn, split, cap,
               static_cast<cudaStream_t>(stream)};
  return launch_block_mm<true>(x, bf16, kernel, tn);
}
