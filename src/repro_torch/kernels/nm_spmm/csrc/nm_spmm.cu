// N:M structured-sparse matmul for Hopper (sm_90a): kernel K3.
//
// out (M, N) f32 = A (M, K) @ W (K, N), with W stored N:M-compressed along
// K: of every m consecutive rows of a column only n are kept.  The kernel
// reads only the compressed arrays: w_vals (K/m*n, N) in A's type (f32 or
// bf16) and the CP offsets of the kept values within their m-group, either
// int8 (K/m*n, N) or bit-packed uint8 (K/m*n/per, N) with bits =
// ceil(log2 m), per = 8 / bits, and compressed row r at bit
// (r % per) * bits of byte r / per (sparsity/nm.py pack_offsets).  No
// dense W exists in global memory.  Repeated offsets add and offsets >= m
// count nothing, as in the reference's one-hot sum.
//
// Replaces the JAX package's kernels/nm_spmm/kernel.py: nm_spmm_kernel /
// _nm_kernel (pl.pallas_call at :89).  There each grid step streamed one
// compressed (bk/m*n, bn) weight tile into VMEM, decompressed it with a
// one-hot compare into a dense (bk, bn) tile and fed the MXU, carrying an
// f32 accumulator across the sequential k steps of the TPU grid.
//
// What bounds it (bounds from the published rates of an H100 SXM at
// 700 W: 3.35 TB/s, 67 TFLOP/s f32 FMA, 989 TFLOP/s bf16 tensor cores,
// 132 SMs), at 2:4:
//   ffn_gate_up (8, 896, 9728) f32: values 17.4 MB, int8 offsets 4.4 MB
//     (packed 1.1 MB), A and out 0.3 MB: 22.1 MB, 6.6 us (packed 5.6 us);
//     70 MFLOP of kept products, 1.0 us.  Bytes.  One 64-column block per
//     output tile walking all of K gave 152 blocks, 1.15 waves, with ~5 KB
//     in flight per SM where ~25 KB are needed: latency, not bytes.
//   lm_head (8, 896, 151936) f32: 345 MB, 103 us (packed 294 MB, 88 us);
//     enough tiles to fill the card, bound by the bytes in flight.
//   ffn_down (128, 4864, 896) bf16: A 1.2 MB, values 4.4 MB, offsets 2.2
//     MB, out 0.5 MB: 8.2 MB, 2.5 us; the dense products after
//     decompression are 1.1 GFLOP, 1.1 us at the tensor-core peak.  Bytes
//     again, but 28 output tiles of 64 x 64 fill a fifth of the card.
//
// What the design does about it.  Two paths, picked by the wrapper's plan
// (kernels/nm_spmm/ops.py plan(), passed in as the kernel, the split and
// the groups per K-slice; the C side checks it):
//
// 1. narrow (f32 at any M, bf16 at M <= 32; CUDA cores).  A block covers
//    8 output rows by 64 groups of 16 bytes of neighbouring columns (4
//    f32 or 8 bf16), two threads to a group, 4 rows each.  Values are
//    read 16 bytes at a time and int8 or packed offset bytes 4 or 8 at a
//    time through a 3-stage cp.async ring (8 compressed rows a stage).
//    A's rows are staged k-major in f32 shared memory 64 k rows at a
//    time, the next 64 loaded into registers while the current ones are
//    used, with a zero row after every m-group; each kept value is
//    multiplied with the A row its offset names (an offset >= m names
//    the zero row): n FMAs per group and output row, not the one-hot's
//    n*m selects and m FMAs.  f32 stays on the FMA pipes (no TF32).  A
//    block takes at most 40 KB of shared memory, so that 5 fit on an SM
//    and lm_head's 594 blocks are resident at once: a second round of
//    blocks would run as a latency-bound tail.  Rows past 8 are more row
//    tiles in the grid, next to each other so that they share the weights
//    in L2; rows past M (a decode at batch 1 to 7) read A as zeros and are
//    not written.  Each kept value gathers 32 bytes of A from shared memory,
//    139 MB at ffn_gate_up; timed with parts cut out (study.py beside
//    ops.py) on an H100 SXM at 700 W, the gathers take a fifth of that
//    cell's time and the loads alone 1.86x its byte bound.
// 2. wide (bf16, M > 32, K % 8 == 0; tensor cores).  A block has a warp
//    per 32 x 32 of its output tile: 64 columns by 64 rows (4 warps), or
//    128 rows (8 warps) when M > 64, which reads the weights once for
//    both 64-row halves.  A 3-stage cp.async ring brings the A tile (64 k,
//    48 at m = 6) and the compressed values and offsets of the same k
//    rows; all threads decompress the stage into a dense bf16 (k, 64)
//    tile in shared memory (one-hot sum in f32, rounded once to bf16, as
//    the reference rounds its dense tile), and each warp multiplies its
//    32 x 32 with mma.sync m16n8k16 (A by ldmatrix, the row-major dense W
//    by ldmatrix.trans), f32 accumulators in registers.  mma.sync and not
//    wgmma: the products are under half the byte bound even at mma.sync's
//    rate, and the dense tile is written by the same warps that read it,
//    so the register-fed mma needs neither wgmma's descriptor layouts nor
//    its asynchronous fences.
//
// 3. general (any 1 <= n < m <= 16, any M and N; CUDA cores).  The five
//    (n, m) above are compiled into the two paths; every other pattern,
//    and a row of values or offsets that does not start 16-byte aligned
//    (N not a multiple of 4 in f32 or 8 in bf16), runs general_kernel,
//    which takes n and m at run time: a thread per output column and 8
//    rows, A staged as on the narrow path, one load per kept value and
//    offset (GU of them in flight a thread), the same n FMAs a group.
//    It is a kernel of its own, not a fallback, and it is slower than
//    the compiled paths: none of its cells is a decode of a configuration
//    the repository serves.  m above 16 is refused (offset_bits stops at
//    4 bits), though int8 offsets could name it.
//
// Every path splits K: the plan cuts K/m into a power of two of K-slices,
// at most 16, of whole stages (so of whole groups and whole bytes of
// packed offsets), the first that puts 2 waves of blocks on the card's
// SMs.  The slices of one output tile are one thread-block cluster (past
// the portable 8 blocks by opting in); each block leaves its partial tile
// in its shared memory, and after a cluster barrier block q sums the q-th
// share of the tile over the ranks in the fixed order 0, 1, ...,
// split-1 through distributed shared memory and writes it: one launch,
// no atomics, the same bits on every call.  At ffn_gate_up that is 38
// column tiles x 8 slices = 304 blocks; at lm_head 594 x 1; at ffn_down
// 14 tiles of 128 x 64 x 16 slices = 224.
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

// (m - 1).bit_length() for 2 <= m <= 16: the width of one CP offset
__host__ __device__ constexpr int offset_bits(int m) {
  return m <= 2 ? 1 : m <= 4 ? 2 : m <= 8 ? 3 : 4;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cp.async of BYTES (4, 8 or 16) bytes; with !valid nothing is read and
// the destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n)
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

// ---------------------------------------------------------------------
// narrow path: CUDA cores, 8 output rows a block
constexpr int NCG = 64;      // column groups per block, 16 bytes each
constexpr int NRS = 2;       // threads per column group
constexpr int NT = NCG * NRS;  // threads per block
constexpr int NR = 8;        // output rows per block
constexpr int RPT = NR / NRS;  // output rows per thread
constexpr int NSTAGES = 3;   // cp.async ring depth
constexpr int NCHUNK = 64;   // A's k rows staged at a time, at most

template <int NN, int MM, typename T, bool PACKED>
struct Narrow {
  static constexpr int VC = 16 / (int)sizeof(T);  // columns per thread
  static constexpr int COLS = NCG * VC;           // columns per block
  static constexpr int BITS = offset_bits(MM);
  static constexpr int PER = 8 / BITS;  // packed offsets per byte
  static constexpr int R = 8;           // compressed rows per stage
  static constexpr int G = R / NN;      // m-groups per stage
  static constexpr int KC = G * MM;     // dense k rows per stage
  static constexpr int RO = PACKED ? R / PER : R;  // offset rows per stage
  static constexpr int CH = NCHUNK / KC * KC;      // A's k rows per chunk
  static constexpr int STEPS_PER_CHUNK = CH / KC;
  // A's rows in shared memory: each m-group's m k rows and a zero row,
  // which offsets >= m read (they count nothing, as in the one-hot sum)
  static constexpr int AROWS = CH / MM * (MM + 1);
  // packed offsets of bits bits can name m or more only when m < 2^bits
  static constexpr bool CLAMP = !PACKED || (1 << BITS) > MM;
  static constexpr size_t V_BYTES = (size_t)NSTAGES * R * COLS * sizeof(T);
  static constexpr size_t O_BYTES = (size_t)NSTAGES * RO * COLS;
  static constexpr size_t A_BYTES = (size_t)AROWS * NR * sizeof(float);
  static constexpr size_t SMEM = V_BYTES + O_BYTES + A_BYTES;
  static_assert(R % NN == 0 && R % PER == 0, "stage must hold whole bytes");
  static_assert(R % NRS == 0 && RO % NRS == 0 && NR * CH % NT == 0 &&
                    RPT % 4 == 0,
                "the threads of a column group share the copies evenly");
  static_assert(NR * COLS * sizeof(float) <= V_BYTES,
                "the partial tile reuses the ring");
  static_assert(SMEM <= 40 * 1024, "5 blocks an SM");
};

// the 16 bytes of values at p as VC floats
__device__ __forceinline__ void load_vals(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// VC offset bytes at p, one per column
__device__ __forceinline__ void load_offs(const uint8_t* p,
                                          unsigned (&o)[4]) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = (x >> (8 * c)) & 0xffu;
}
__device__ __forceinline__ void load_offs(const uint8_t* p,
                                          unsigned (&o)[8]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = (x.x >> (8 * c)) & 0xffu;
    o[c + 4] = (x.y >> (8 * c)) & 0xffu;
  }
}

// grid (split, ceil(M / 8), ceil(N / COLS)), clusters of (split, 1, 1):
// block (s, i, j) sums K-slice s (groups [s*gs, min((s+1)*gs, K/m))) of
// the output tile (i, j); rows past M read A as zeros and are not
// written, and N is a multiple of VC.  Thread (h, c) copies every NRS-th
// compressed row of column group c from row h, and sums output rows
// h*RPT ... of it.
template <int NN, int MM, typename T, bool PACKED>
__global__ void __launch_bounds__(NT)
narrow_kernel(const T* __restrict__ a, const T* __restrict__ vals,
              const uint8_t* __restrict__ idx, float* __restrict__ out,
              int M, int K, int N, int gs) {
  using P = Narrow<NN, MM, T, PACKED>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Vs = reinterpret_cast<T*>(smem);
  uint8_t* Os = smem + P::V_BYTES;
  float(*At)[NR] =
      reinterpret_cast<float(*)[NR]>(smem + P::V_BYTES + P::O_BYTES);
  const int tid = threadIdx.x, cg = tid % NCG, h = tid / NCG;
  const int row0 = blockIdx.y * NR;
  const int col = blockIdx.z * P::COLS + cg * P::VC;
  const bool live = col < N;
  const int g0 = blockIdx.x * gs;
  const int g1 = min(K / MM, g0 + gs);
  const int steps = (g1 - g0 + P::G - 1) / P::G;
  const int r_end = g1 * NN;  // this slice's compressed rows end here

  // this thread's share of step st's values and offsets, into its slot
  auto load = [&](int st) {
    const int slot = st % NSTAGES;
    const int r0 = g0 * NN + st * P::R;
    T* vd = Vs + (size_t)slot * P::R * P::COLS + cg * P::VC;
#pragma unroll
    for (int j = 0; j < P::R / NRS; ++j) {
      const int q = h + j * NRS;
      const bool ok = live && r0 + q < r_end;
      cp_async<16>(vd + q * P::COLS,
                   ok ? vals + (size_t)(r0 + q) * N + col : vals, ok);
    }
    uint8_t* od = Os + (size_t)slot * P::RO * P::COLS + cg * P::VC;
    const int b0 = PACKED ? r0 / P::PER : r0;
    const int b_end = PACKED ? r_end / P::PER : r_end;
#pragma unroll
    for (int j = 0; j < P::RO / NRS; ++j) {
      const int q = h + j * NRS;
      const bool ok = live && b0 + q < b_end;
      cp_async<P::VC>(od + q * P::COLS,
                      ok ? idx + (size_t)(b0 + q) * N + col : idx, ok);
    }
  };

  float acc[RPT][P::VC];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < P::VC; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int st = 0; st < NSTAGES - 1; ++st) {
    if (st < steps) load(st);
    cp_commit();
  }
  for (int e = tid; e < P::CH / MM * NR; e += NT)  // the zero rows
    At[(e / NR) * (MM + 1) + MM][e % NR] = 0.f;
  // A's chunk from step st on, into registers: the next chunk's loads are
  // in flight while the current chunk's steps run
  float x[NR * P::CH / NT];
  auto fetch = [&](int st) {
    const int k0 = (g0 + st * P::G) * MM, k_end = g1 * MM;
#pragma unroll
    for (int q = 0; q < NR * P::CH / NT; ++q) {
      const int e = tid + q * NT, r = e / P::CH, k = k0 + e % P::CH;
      x[q] = k < k_end && row0 + r < M
                 ? to_f32(a[(size_t)(row0 + r) * K + k])
                 : 0.f;
    }
  };
  fetch(0);
  for (int st = 0; st < steps; ++st) {
    cp_wait<NSTAGES - 2>();  // step st's copies (this thread's) are in
    __syncthreads();  // ... everyone's, and everyone is done with st - 1
    if (st + NSTAGES - 1 < steps) load(st + NSTAGES - 1);
    cp_commit();
    if (st % P::STEPS_PER_CHUNK == 0) {  // A's chunk, k-major f32
#pragma unroll
      for (int q = 0; q < NR * P::CH / NT; ++q) {
        const int e = tid + q * NT, kk = e % P::CH;
        At[kk / MM * (MM + 1) + kk % MM][e / P::CH] = x[q];
      }
      __syncthreads();
      if (st + P::STEPS_PER_CHUNK < steps) fetch(st + P::STEPS_PER_CHUNK);
    }
    const int slot = st % NSTAGES;
    const T* vs = Vs + (size_t)slot * P::R * P::COLS + cg * P::VC;
    const uint8_t* os = Os + (size_t)slot * P::RO * P::COLS + cg * P::VC;
    const int gb = (st % P::STEPS_PER_CHUNK) * P::G;  // group in chunk
    const int left = g1 - (g0 + st * P::G);  // groups left in the slice
#pragma unroll
    for (int g = 0; g < P::G; ++g) {
      if (g < left) {  // uniform: only a slice's last step holds fewer
#pragma unroll
        for (int i = 0; i < NN; ++i) {
          const int q = g * NN + i;
          float v[P::VC];
          unsigned o[P::VC];
          load_vals(vs + q * P::COLS, v);
          load_offs(os + (PACKED ? q / P::PER : q) * P::COLS, o);
#pragma unroll
          for (int c = 0; c < P::VC; ++c) {
            unsigned off = o[c];
            if (PACKED)
              off = (off >> ((q % P::PER) * P::BITS)) & ((1u << P::BITS) - 1);
            if (P::CLAMP) off = min(off, (unsigned)MM);
            const float* ar = At[(gb + g) * (MM + 1) + off] + h * RPT;
#pragma unroll
            for (int r = 0; r < RPT; r += 4) {
              const float4 a4 = *reinterpret_cast<const float4*>(ar + r);
              acc[r][c] = fmaf(a4.x, v[c], acc[r][c]);
              acc[r + 1][c] = fmaf(a4.y, v[c], acc[r + 1][c]);
              acc[r + 2][c] = fmaf(a4.z, v[c], acc[r + 2][c]);
              acc[r + 3][c] = fmaf(a4.w, v[c], acc[r + 3][c]);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();

  if (gridDim.x == 1) {
    if (live)
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (row0 + h * RPT + r < M)
#pragma unroll
          for (int c = 0; c < P::VC; c += 4)
            *reinterpret_cast<float4*>(
                out + (size_t)(row0 + h * RPT + r) * N + col + c) =
                make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2],
                            acc[r][c + 3]);
    return;
  }
  __syncthreads();  // the ring is free: the partial tile goes there
  float* red = reinterpret_cast<float*>(smem);  // [NR][COLS]
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < P::VC; c += 4)
      *reinterpret_cast<float4*>(red + (h * RPT + r) * P::COLS +
                                 cg * P::VC + c) =
          make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
  const int col0 = blockIdx.z * P::COLS;
  cluster_reduce(red, NR * P::COLS, NT, [&](int e4, float4 sum) {
    const int r = e4 / (P::COLS / 4), c = col0 + (e4 % (P::COLS / 4)) * 4;
    if (c < N && row0 + r < M)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * N + c) = sum;
  });
}

// ---------------------------------------------------------------------
// general path: any n:m (1 <= n < m <= 16), any N, any M; CUDA cores
constexpr int GT = 128;  // threads per block: one output column each
constexpr int GU = 8;    // compressed rows whose loads a thread has in flight

// grid (split, ceil(M / 8), ceil(N / GT)), clusters of (split, 1, 1):
// block (s, i, j) sums K-slice s (groups [s*gs, min((s+1)*gs, K/m))) of
// the 8 x GT output tile (i, j); thread c owns column j*GT + c and its 8
// rows.  A's rows are staged `chunk` groups at a time, k-major in f32 with
// a zero row after each group, as on the narrow path, and each kept value
// is multiplied with the A row its offset names (n FMAs per group and
// row).  Values and offsets are read one element per thread and row, GU
// rows at a time: a row of N values may start anywhere, so nothing wider
// is aligned, and no load reaches past a row's N columns.
// (The minimum of 4 blocks an SM lets the compiler use up to 128
// registers; with the thread count alone it spilled to reach 80.)
template <typename T, bool PACKED>
__global__ void __launch_bounds__(GT, 4)
general_kernel(const T* __restrict__ a, const T* __restrict__ vals,
               const uint8_t* __restrict__ idx, float* __restrict__ out,
               int M, int K, int N, int n, int m, int gs, int chunk) {
  extern __shared__ __align__(16) float As[];  // [chunk][m + 1][NR]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * NR, col0 = blockIdx.z * GT;
  const int col = col0 + tid;
  const bool live = col < N;
  const int g0 = blockIdx.x * gs;
  const int g1 = min(K / m, g0 + gs);
  const int bits = offset_bits(m), per = 8 / bits;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  for (int c0 = g0; c0 < g1; c0 += chunk) {
    const int c1 = min(g1, c0 + chunk), slots = (c1 - c0) * (m + 1);
    __syncthreads();  // the last chunk's gathers are done
    for (int e = tid; e < slots * NR; e += GT) {  // k fastest: coalesced
      const int r = e / slots, j = e - r * slots;
      const int g = j / (m + 1), p = j - g * (m + 1);
      float x = 0.f;
      if (p < m && row0 + r < M)
        x = to_f32(a[(size_t)(row0 + r) * K + (size_t)(c0 + g) * m + p]);
      As[j * NR + r] = x;
    }
    __syncthreads();
    if (!live) continue;
    const int q1 = c1 * n;
    for (int q0 = c0 * n; q0 < q1; q0 += GU) {
      float v[GU];
      unsigned o[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int q = q0 + u;
        v[u] = q < q1 ? to_f32(vals[(size_t)q * N + col]) : 0.f;
        o[u] = q < q1 ? idx[(size_t)(PACKED ? q / per : q) * N + col] : 0u;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int q = q0 + u;
        if (q >= q1) break;
        unsigned off = o[u];
        if (PACKED) off = (off >> ((q % per) * bits)) & ((1u << bits) - 1);
        off = min(off, (unsigned)m);  // >= m: the zero row, as the one-hot
        const float* ar = As + ((q / n - c0) * (m + 1) + off) * NR;
        const float4 lo = *reinterpret_cast<const float4*>(ar);
        const float4 hi = *reinterpret_cast<const float4*>(ar + 4);
        acc[0] = fmaf(lo.x, v[u], acc[0]);
        acc[1] = fmaf(lo.y, v[u], acc[1]);
        acc[2] = fmaf(lo.z, v[u], acc[2]);
        acc[3] = fmaf(lo.w, v[u], acc[3]);
        acc[4] = fmaf(hi.x, v[u], acc[4]);
        acc[5] = fmaf(hi.y, v[u], acc[5]);
        acc[6] = fmaf(hi.z, v[u], acc[6]);
        acc[7] = fmaf(hi.w, v[u], acc[7]);
      }
    }
  }

  const bool whole_k = gridDim.x == 1;
  if (whole_k) {
    if (live)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (row0 + r < M) out[(size_t)(row0 + r) * N + col] = acc[r];
    return;
  }
  __syncthreads();  // the staged A is free: the partial tile goes there
  float* red = As;  // [NR][GT]
#pragma unroll
  for (int r = 0; r < NR; ++r) red[r * GT + tid] = acc[r];
  cluster_reduce(red, NR * GT, GT, [&](int e4, float4 sum) {
    const int r = row0 + e4 / (GT / 4), c = col0 + (e4 % (GT / 4)) * 4;
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
    if (r < M)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < N) out[(size_t)r * N + c + i] = s4[i];
  });
}

// its dynamic shared memory: the staged A, which the partial tile reuses
size_t general_smem(int m, int chunk) {
  const size_t a = (size_t)chunk * (m + 1) * NR * sizeof(float);
  const size_t red = (size_t)NR * GT * sizeof(float);
  return a > red ? a : red;
}
// A's groups staged at a time: about 256 k rows
int general_chunk(int m) { return 256 / m > 1 ? 256 / m : 1; }

// ---------------------------------------------------------------------
// wide path: bf16 on the tensor cores, BM (64 or 128) x 64 output tiles
constexpr int WN = 64;
constexpr int WSTAGES = 3;

template <int NN, int MM, int BM, bool PACKED>
struct Wide {
  static constexpr int THREADS = BM * WN / 1024 * 32;  // a warp per 32 x 32
  // dense k rows per stage: whole groups and whole 16-deep mma steps
  static constexpr int KC = MM == 6 ? 48 : 64;
  static constexpr int G = KC / MM;  // m-groups per stage
  static constexpr int R = G * NN;   // compressed rows per stage
  static constexpr int BITS = offset_bits(MM);
  static constexpr int PER = 8 / BITS;
  static constexpr int RO = PACKED ? R / PER : R;
  static constexpr int AS = KC + 8;  // row strides padded by 16 bytes:
  static constexpr int WS = WN + 8;  // ldmatrix rows on distinct banks
  static constexpr size_t A_BYTES = (size_t)BM * AS * 2;
  static constexpr size_t V_BYTES = (size_t)R * WN * 2;
  static constexpr size_t O_BYTES = (size_t)RO * WN;
  static constexpr size_t STAGE = A_BYTES + V_BYTES + O_BYTES;
  static constexpr size_t SMEM = WSTAGES * STAGE + (size_t)KC * WS * 2;
  static_assert(KC % 16 == 0 && KC % MM == 0 && R % PER == 0,
                "stage must hold whole groups, mma steps and bytes");
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
  static_assert((size_t)BM * WN * 4 <= WSTAGES * STAGE,
                "the partial tile reuses the ring");
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

// grid (split, ceil(M / BM), ceil(N / 64)), clusters of (split, 1, 1)
template <int NN, int MM, int BM, bool PACKED>
__global__ void __launch_bounds__(Wide<NN, MM, BM, PACKED>::THREADS)
wide_kernel(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ vals,
            const uint8_t* __restrict__ idx, float* __restrict__ out, int M,
            int K, int N, int gs) {
  using P = Wide<NN, MM, BM, PACKED>;
  using bf16 = __nv_bfloat16;
  constexpr int WT = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem + WSTAGES * P::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.z * WN;
  const int g0 = blockIdx.x * gs;
  const int g1 = min(K / MM, g0 + gs);
  const int steps = (g1 - g0 + P::G - 1) / P::G;
  const int r_end = g1 * NN, k_end = g1 * MM;

  // step st's A tile, values and offsets into its slot; rows, k and
  // columns outside the slice or the matrices read as zeros
  auto load = [&](int st) {
    unsigned char* base = smem + (st % WSTAGES) * P::STAGE;
    bf16* As = reinterpret_cast<bf16*>(base);
    bf16* Vs = reinterpret_cast<bf16*>(base + P::A_BYTES);
    uint8_t* Os = base + P::A_BYTES + P::V_BYTES;
    const int k0 = (g0 + st * P::G) * MM, r0 = g0 * NN + st * P::R;
    for (int e = tid; e < BM * P::KC / 8; e += WT) {
      const int r = e / (P::KC / 8), k = k0 + (e % (P::KC / 8)) * 8;
      const bool ok = row0 + r < M && k < k_end;
      cp_async<16>(As + r * P::AS + k - k0,
                   ok ? a + (size_t)(row0 + r) * K + k : a, ok);
    }
    for (int e = tid; e < P::R * WN / 8; e += WT) {
      const int q = e / (WN / 8), c = (e % (WN / 8)) * 8;
      const bool ok = r0 + q < r_end && col0 + c < N;
      cp_async<16>(Vs + q * WN + c,
                   ok ? vals + (size_t)(r0 + q) * N + col0 + c : vals, ok);
    }
    const int b0 = PACKED ? r0 / P::PER : r0;
    const int b_end = PACKED ? r_end / P::PER : r_end;
    for (int e = tid; e < P::RO * WN / 16; e += WT) {
      const int q = e / (WN / 16), c = (e % (WN / 16)) * 16;
      const bool ok = b0 + q < b_end && col0 + c < N;
      cp_async<16>(Os + q * WN + c,
                   ok ? idx + (size_t)(b0 + q) * N + col0 + c : idx, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;
  const int wm = warp / (WN / 32), wn = warp % (WN / 32);

#pragma unroll
  for (int st = 0; st < WSTAGES - 1; ++st) {
    if (st < steps) load(st);
    cp_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_wait<WSTAGES - 2>();
    __syncthreads();  // step st is in for all; step st-1's products done
    if (st + WSTAGES - 1 < steps) load(st + WSTAGES - 1);
    cp_commit();
    const unsigned char* base = smem + (st % WSTAGES) * P::STAGE;
    const bf16* As = reinterpret_cast<const bf16*>(base);
    const bf16* Vs = reinterpret_cast<const bf16*>(base + P::A_BYTES);
    const uint8_t* Os = base + P::A_BYTES + P::V_BYTES;
    // decompress: each (group, 4 columns) into m dense rows of Ws; the
    // zero-filled groups past the slice give zero rows
    for (int e = tid; e < P::G * WN / 4; e += WT) {
      const int g = e / (WN / 4), c = (e % (WN / 4)) * 4;
      float w[MM][4];
#pragma unroll
      for (int p = 0; p < MM; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[p][j] = 0.f;
#pragma unroll
      for (int i = 0; i < NN; ++i) {
        const int q = g * NN + i;
        const uint2 vv = *reinterpret_cast<const uint2*>(Vs + q * WN + c);
        const float v[4] = {__uint_as_float(vv.x << 16),
                            __uint_as_float(vv.x & 0xffff0000u),
                            __uint_as_float(vv.y << 16),
                            __uint_as_float(vv.y & 0xffff0000u)};
        const unsigned ob = *reinterpret_cast<const unsigned*>(
            Os + (PACKED ? q / P::PER : q) * WN + c);
        const int sh = PACKED ? (q % P::PER) * P::BITS : 0;
        const unsigned mask = PACKED ? (1u << P::BITS) - 1 : 0xffu;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned o = (ob >> (8 * j + sh)) & mask;
#pragma unroll
          for (int p = 0; p < MM; ++p) w[p][j] += o == (unsigned)p ? v[j] : 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < MM; ++p) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(w[p][0], w[p][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(w[p][2], w[p][3]);
        *reinterpret_cast<uint2*>(Ws + (g * MM + p) * P::WS + c) =
            make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                       *reinterpret_cast<const unsigned*>(&hi));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P::KC; kk += 16) {
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
  }
  cp_wait<0>();

  // this thread's accumulators: rows wm*32 + i*16 + lane/4 (+ 8), columns
  // wn*32 + j*8 + (lane%4)*2 (+ 1)
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
          const int c = col0 + wn * 32 + j * 8 + (lane & 3) * 2;
          if (r < M && c < N)
            *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }
  __syncthreads();  // the ring is free: the partial tile goes there
  float* red = reinterpret_cast<float*>(smem);  // [BM][WN]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + (lane >> 2) + h * 8;
        const int c = wn * 32 + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(red + r * WN + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cluster_reduce(red, BM * WN, WT, [&](int e4, float4 sum) {
    const int r = row0 + e4 / (WN / 4), c = col0 + (e4 % (WN / 4)) * 4;
    if (r < M && c < N)
      *reinterpret_cast<float4*>(out + (size_t)r * N + c) = sum;
  });
}

// ---------------------------------------------------------------------
struct Args {
  const void* a;
  const void* vals;
  const uint8_t* idx;
  float* out;
  int M, K, N, split, gs;
  cudaStream_t s;
};

// above 48 KB of shared memory, and clusters above 8 blocks, only after
// opting in, once per kernel
template <auto Kernel>
cudaError_t opt_in(size_t smem) {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  cudaError_t e = opt_in<Kernel>(smem);
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

template <int NN, int MM, typename T, bool PACKED>
cudaError_t launch_narrow(const Args& x) {
  using P = Narrow<NN, MM, T, PACKED>;
  if (x.N % P::VC || x.gs % P::G) return cudaErrorInvalidValue;
  const dim3 grid(x.split, (x.M + NR - 1) / NR, (x.N + P::COLS - 1) / P::COLS);
  return launch<narrow_kernel<NN, MM, T, PACKED>>(
      x, grid, NT, P::SMEM, static_cast<const T*>(x.a),
      static_cast<const T*>(x.vals), x.idx, x.out, x.M, x.K, x.N, x.gs);
}

// its shared memory depends on m: the opt-in covers every m (under 48 KB)
constexpr size_t GENERAL_MAX_SMEM = 48 * 1024;

template <typename T, bool PACKED>
cudaError_t launch_general(const Args& x, int n, int m) {
  const cudaError_t e = opt_in<general_kernel<T, PACKED>>(GENERAL_MAX_SMEM);
  if (e != cudaSuccess) return e;
  const int chunk = general_chunk(m);
  const dim3 grid(x.split, (x.M + NR - 1) / NR, (x.N + GT - 1) / GT);
  return launch<general_kernel<T, PACKED>>(
      x, grid, GT, general_smem(m, chunk), static_cast<const T*>(x.a),
      static_cast<const T*>(x.vals), x.idx, x.out, x.M, x.K, x.N, n, m, x.gs,
      chunk);
}

template <int NN, int MM, int BM, bool PACKED>
cudaError_t launch_wide(const Args& x) {
  using P = Wide<NN, MM, BM, PACKED>;
  if (x.K % 8 || x.N % 16 || x.gs % P::G) return cudaErrorInvalidValue;
  const dim3 grid(x.split, (x.M + BM - 1) / BM, (x.N + WN - 1) / WN);
  return launch<wide_kernel<NN, MM, BM, PACKED>>(
      x, grid, P::THREADS, P::SMEM, static_cast<const __nv_bfloat16*>(x.a),
      static_cast<const __nv_bfloat16*>(x.vals), x.idx, x.out, x.M, x.K,
      x.N, x.gs);
}

template <int NN, int MM, bool PACKED>
cudaError_t launch_path(const Args& x, int kernel, int bf16) {
  if (kernel && !bf16) return cudaErrorInvalidValue;  // f32 never on TF32
  switch (kernel) {
    case 0: return bf16 ? launch_narrow<NN, MM, __nv_bfloat16, PACKED>(x)
                        : launch_narrow<NN, MM, float, PACKED>(x);
    case 1: return launch_wide<NN, MM, 64, PACKED>(x);
    case 2: return launch_wide<NN, MM, 128, PACKED>(x);
    default: return cudaErrorInvalidValue;
  }
}

template <int NN, int MM>
cudaError_t launch_nm(const Args& x, int packed, int kernel, int bf16) {
  return packed ? launch_path<NN, MM, true>(x, kernel, bf16)
                : launch_path<NN, MM, false>(x, kernel, bf16);
}

template <auto Kernel>
cudaError_t kernel_info(size_t smem, int threads, int stage_groups,
                        int* info) {
  cudaError_t e = opt_in<Kernel>(smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, Kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  info[0] = stage_groups;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)smem;
  info[4] = blocks;
  info[5] = threads;
  return cudaSuccess;
}

template <int NN, int MM, int BM, bool PACKED>
cudaError_t info_wide(int* info) {
  using P = Wide<NN, MM, BM, PACKED>;
  return kernel_info<wide_kernel<NN, MM, BM, PACKED>>(P::SMEM, P::THREADS,
                                                      P::G, info);
}

template <int NN, int MM, bool PACKED>
cudaError_t info_path(int kernel, int bf16, int* info) {
  if (kernel && !bf16) return cudaErrorInvalidValue;
  if (kernel == 1) return info_wide<NN, MM, 64, PACKED>(info);
  if (kernel == 2) return info_wide<NN, MM, 128, PACKED>(info);
  if (kernel) return cudaErrorInvalidValue;
  if (bf16) {
    using P = Narrow<NN, MM, __nv_bfloat16, PACKED>;
    return kernel_info<narrow_kernel<NN, MM, __nv_bfloat16, PACKED>>(
        P::SMEM, NT, P::G, info);
  }
  using P = Narrow<NN, MM, float, PACKED>;
  return kernel_info<narrow_kernel<NN, MM, float, PACKED>>(P::SMEM, NT, P::G,
                                                           info);
}

template <int NN, int MM>
cudaError_t info_nm(int packed, int kernel, int bf16, int* info) {
  return packed ? info_path<NN, MM, true>(kernel, bf16, info)
                : info_path<NN, MM, false>(kernel, bf16, info);
}

template <typename T, bool PACKED>
cudaError_t info_general(int m, int* info) {
  const cudaError_t e = opt_in<general_kernel<T, PACKED>>(GENERAL_MAX_SMEM);
  if (e != cudaSuccess) return e;
  return kernel_info<general_kernel<T, PACKED>>(
      general_smem(m, general_chunk(m)), GT, 1, info);
}

}  // namespace

// What serves (n, m, packed, kernel, bf16), in info[0..5]: m-groups per
// ring stage (a K-slice's groups are a multiple of it), registers per
// thread, local memory per thread in bytes (spills and stack), dynamic
// shared memory per block in bytes, resident blocks per SM, threads per
// block.  kernel 0 = narrow (CUDA cores), 1 and 2 = wide (bf16 tensor
// cores) with 64- and 128-row tiles, for the five compiled (n, m); 3 =
// general (CUDA cores) for any 1 <= n < m <= 16, with a stage of one
// group.  Returns cudaErrorInvalidValue for an (n, m) or kernel that the
// library does not hold.
extern "C" int nm_spmm_info(int n, int m, int packed, int kernel, int bf16,
                            int* info) {
  if (kernel == 3) {
    if (n < 1 || n >= m || m > 16) return cudaErrorInvalidValue;
    if (bf16)
      return packed ? info_general<__nv_bfloat16, true>(m, info)
                    : info_general<__nv_bfloat16, false>(m, info);
    return packed ? info_general<float, true>(m, info)
                  : info_general<float, false>(m, info);
  }
  if (n == 2 && m == 4) return info_nm<2, 4>(packed, kernel, bf16, info);
  if (n == 1 && m == 4) return info_nm<1, 4>(packed, kernel, bf16, info);
  if (n == 2 && m == 6) return info_nm<2, 6>(packed, kernel, bf16, info);
  if (n == 2 && m == 8) return info_nm<2, 8>(packed, kernel, bf16, info);
  if (n == 4 && m == 8) return info_nm<4, 8>(packed, kernel, bf16, info);
  return cudaErrorInvalidValue;
}

// Plain C interface (ctypes).  Pointers are device pointers, 16-byte
// aligned (else cudaErrorMisalignedAddress); the stream is a
// cudaStream_t.  idx holds int8 offsets (packed = 0) or bit-packed uint8
// (packed = 1).  The plan: kernel (0 narrow; 1 and 2 wide, bf16 only,
// with 64- and 128-row tiles; these three for the five compiled (n, m)
// only; 3 general, any 1 <= n < m <= 16), split K-slices of gs m-groups
// each (gs a multiple of the kernel's stage groups, the last slice
// non-empty, split <= 16).  The narrow path reads 16 bytes of
// neighbouring columns per thread, so N must be a multiple of 4 (f32) or
// 8 (bf16) there; the wide path needs N % 16 == 0 and K % 8 == 0; the
// general path takes any M, N.  Anything else returns
// cudaErrorInvalidValue; otherwise the launch's cudaError_t (0 on
// success).
extern "C" int nm_spmm(const void* a, const void* vals, const void* idx,
                       void* out, int M, int K, int N, int n, int m,
                       int packed, int bf16, int kernel, int split, int gs,
                       void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n <= 0 || n >= m || m > 16 || K % m ||
      split < 1 || split > MAX_SPLIT || gs <= 0 ||
      (long long)(split - 1) * gs >= K / m || (long long)split * gs < K / m ||
      (N + GT - 1) / GT > 65535 || (M + 7) / 8 > 65535)
    return cudaErrorInvalidValue;
  if (packed && ((K / m) * n) % (8 / offset_bits(m)))
    return cudaErrorInvalidValue;
  for (const void* p : {a, vals, idx, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const Args x{a, vals, static_cast<const uint8_t*>(idx),
               static_cast<float*>(out), M, K, N, split, gs,
               static_cast<cudaStream_t>(stream)};
  if (kernel == 3) {
    if (bf16)
      return packed ? launch_general<__nv_bfloat16, true>(x, n, m)
                    : launch_general<__nv_bfloat16, false>(x, n, m);
    return packed ? launch_general<float, true>(x, n, m)
                  : launch_general<float, false>(x, n, m);
  }
  if (n == 2 && m == 4) return launch_nm<2, 4>(x, packed, kernel, bf16);
  if (n == 1 && m == 4) return launch_nm<1, 4>(x, packed, kernel, bf16);
  if (n == 2 && m == 6) return launch_nm<2, 6>(x, packed, kernel, bf16);
  if (n == 2 && m == 8) return launch_nm<2, 8>(x, packed, kernel, bf16);
  if (n == 4 && m == 8) return launch_nm<4, 8>(x, packed, kernel, bf16);
  return cudaErrorInvalidValue;
}
