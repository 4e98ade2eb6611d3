// Block-sparse matmuls for Hopper (sm_90a): the paper's SKIP vs GATE
// taxonomy as two kernels.  Both compute out (M, N) f32 = A (M, K) @ W
// (K, N) summed over the (k, j) blocks of W that a block list or mask
// names; A and W are f32 or bf16 (widened to f32), row-major, contiguous.
//
// K1 SKIP (skip_mm_kernel) replaces the JAX package's
//   kernels/block_mm/kernel.py: skip_mm_kernel / _skip_kernel.
//   There the grid was (M/bm, nnzb) over the nonzero blocks sorted by j,
//   and an f32 VMEM accumulator carried across consecutive grid steps of
//   one column, relying on the TPU running its grid in order.  GPU blocks
//   run in no order, so here each (i, j) output tile is one thread block
//   that loops over its own run of nonzero blocks, colptr[j] ..
//   colptr[j+1] (column pointers built by the wrapper from the sorted
//   block list), and keeps the sum in registers.  Empty W blocks are
//   never read: SKIP saves the bytes and the time.
//
// K2 GATE (gated_mm_kernel) replaces kernels/block_mm/kernel.py:
//   gated_mm_kernel / _gated_kernel, the full (M/bm, N/bn, K/bk) grid with
//   the dot predicated by block_mask[k, j].  Here each (i, j) output tile
//   is one thread block that walks every k block.  The A and W tiles are
//   loaded into shared memory UNCONDITIONALLY; only the FMAs sit under
//   the mask.  If the loads went under the branch, GATE would turn into
//   SKIP (it would stop paying for the bytes of empty blocks) and the
//   gate-time agreement arm would measure the wrong mechanism.
//
// What bounds them: at the validate cells (M = 8 decode rows, K, N in the
// thousands) each W element is used M times, far below the ~20 FLOP/byte
// the card needs before its f32 rate (67 TFLOP/s) is the limit, so both
// kernels should be bound by the W bytes they read over 3.35 TB/s: every
// block for GATE, the nonzero blocks for SKIP.  For GATE that is also what
// makes the paper's claim measurable: if the FMAs, not the loads, bounded
// the kernel, predicating them would save time.  So the design keeps the
// arithmetic cheap next to the loads: W reads are coalesced (one thread
// per output column, a warp reads 128 contiguous bytes of a W row); A is
// staged k-major so a thread reads the BM rows of one k as float4
// broadcasts (3 shared loads per 8 FMAs at BM = 8); staging loops have
// compile-time length; and the next step's A and W are loaded into
// registers while the current step's FMAs run.  No wgmma, TMA or
// multi-stage ring yet: a simple FMA kernel that is right comes first.
//
// Thread block: BN threads (one per output column; BN in {32, 64, 128});
// BM output rows per thread (8..128); KC k rows per step.  All three are
// template parameters.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_BN = 128;  // widest column tile (one thread per column)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// k rows per step: fewer for tall tiles, to bound the registers that hold
// the next step's A slab (BM * KC / BN of them)
template <int BM>
struct Step {
  static constexpr int KC = BM >= 128 ? 8 : BM >= 64 ? 16 : 32;
};

// The next step's slabs, in registers: A[row0 : row0+BM, k0 : k0+KC]
// (A_PER elements per thread, k fastest across threads) and this thread's
// column of W[k0 : k0+KC, col0 : col0+BN].
template <int BM, int BN, typename T>
struct Slab {
  static constexpr int KC = Step<BM>::KC;
  static constexpr int A_PER = BM * KC / BN;
  float a[A_PER];
  float w[KC];

  __device__ __forceinline__ void load(const T* __restrict__ A,
                                       const T* __restrict__ W, int row0,
                                       int col0, int k0, int K, int N) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = tid + q * BN;
      a[q] = to_f32(A[(size_t)(row0 + e / KC) * K + k0 + e % KC]);
    }
    const T* wp = W + (size_t)k0 * N + col0 + tid;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) w[kk] = to_f32(wp[(size_t)kk * N]);
  }

  // A goes in k-major (As[kk][r]) so the FMA loop reads rows as float4
  __device__ __forceinline__ void store(float (*As)[BM],
                                        float (*Ws)[BN]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = tid + q * BN;
      As[e % KC][e / KC] = a[q];
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) Ws[kk][tid] = w[kk];
  }
};

template <int BM, int BN>
__device__ __forceinline__ void fma_step(float (&acc)[BM],
                                         const float (*As)[BM],
                                         const float (*Ws)[BN]) {
  constexpr int KC = Step<BM>::KC;
#pragma unroll 4
  for (int kk = 0; kk < KC; ++kk) {
    const float wv = Ws[kk][threadIdx.x];
#pragma unroll
    for (int r = 0; r < BM; r += 4) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][r]);
      acc[r] = fmaf(av.x, wv, acc[r]);
      acc[r + 1] = fmaf(av.y, wv, acc[r + 1]);
      acc[r + 2] = fmaf(av.z, wv, acc[r + 2]);
      acc[r + 3] = fmaf(av.w, wv, acc[r + 3]);
    }
  }
}

template <int BM>
__device__ __forceinline__ void store_out(const float (&acc)[BM],
                                          float* __restrict__ out,
                                          int row0, int col0, int N) {
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    out[(size_t)(row0 + r) * N + col0 + threadIdx.x] = acc[r];
  }
}

// K1 SKIP: grid (N/BN, M/BM); block (j, i) walks only its column's run of
// nonzero k blocks, kidx[colptr[j] .. colptr[j+1]), KC rows per step.
template <int BM, int BN, typename T>
__global__ void __launch_bounds__(BN)
skip_mm_kernel(const T* __restrict__ a, const T* __restrict__ w,
               const int* __restrict__ kidx, const int* __restrict__ colptr,
               float* __restrict__ out, int K, int N, int bk) {
  constexpr int KC = Step<BM>::KC;
  __shared__ __align__(16) float As[KC][BM];
  __shared__ __align__(16) float Ws[KC][BN];
  const int j = blockIdx.x;
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const int sub = bk / KC;  // steps per k block
  const int e0 = colptr[j];
  const int steps = (colptr[j + 1] - e0) * sub;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  Slab<BM, BN, T> slab;
  if (steps > 0) slab.load(a, w, row0, col0, kidx[e0] * bk, K, N);
  // the k block of step s + 1, read one step ahead: a W load must not
  // wait on the index load that gives its address
  int kb_next = steps > 1 ? kidx[e0 + 1 / sub] : 0;
  for (int s = 0; s < steps; ++s) {
    slab.store(As, Ws);
    __syncthreads();
    const int t = s + 1;
    if (t < steps)  // in flight while this step's FMAs run
      slab.load(a, w, row0, col0, kb_next * bk + (t % sub) * KC, K, N);
    if (t + 1 < steps) kb_next = kidx[e0 + (t + 1) / sub];
    fma_step<BM, BN>(acc, As, Ws);
    __syncthreads();
  }
  store_out<BM>(acc, out, row0, col0, N);
}

// K2 GATE: grid (N/BN, M/BM); block (j, i) walks every k block.  The A
// and W slabs are loaded and stored to shared memory whatever the mask
// says (the stores keep the compiler from dropping the loads); only the
// FMAs are predicated.
template <int BM, int BN, typename T>
__global__ void __launch_bounds__(BN)
gated_mm_kernel(const T* __restrict__ a, const T* __restrict__ w,
                const int* __restrict__ mask, float* __restrict__ out, int K,
                int N, int bk) {
  constexpr int KC = Step<BM>::KC;
  __shared__ __align__(16) float As[KC][BM];
  __shared__ __align__(16) float Ws[KC][BN];
  const int j = blockIdx.x;
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const int nbn = N / BN, sub = bk / KC;
  const int steps = (K / bk) * sub;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  Slab<BM, BN, T> slab;
  slab.load(a, w, row0, col0, 0, K, N);
  for (int s = 0; s < steps; ++s) {
    slab.store(As, Ws);  // never gated
    __syncthreads();
    const bool on = mask[(s / sub) * nbn + j] != 0;  // uniform per block
    if (s + 1 < steps) slab.load(a, w, row0, col0, (s + 1) * KC, K, N);
    if (on) fma_step<BM, BN>(acc, As, Ws);
    __syncthreads();
  }
  store_out<BM>(acc, out, row0, col0, N);
}

#define BM_CASES(LAUNCH)                 \
  switch (bm) {                          \
    case 8: LAUNCH(8); break;            \
    case 16: LAUNCH(16); break;          \
    case 32: LAUNCH(32); break;          \
    case 64: LAUNCH(64); break;          \
    case 128: LAUNCH(128); break;        \
    default: return cudaErrorInvalidValue; \
  }

template <int BN, typename T>
cudaError_t launch_skip(const void* a, const void* w, const int* kidx,
                        const int* colptr, float* out, int M, int K, int N,
                        int bm, int bk, cudaStream_t s) {
  const dim3 grid(N / BN, M / bm), block(BN);
  const T* A = static_cast<const T*>(a);
  const T* W = static_cast<const T*>(w);
#define SKIP(BM_) \
  skip_mm_kernel<BM_, BN, T><<<grid, block, 0, s>>>(A, W, kidx, colptr, out, K, N, bk)
  BM_CASES(SKIP)
#undef SKIP
  return cudaGetLastError();
}

template <int BN, typename T>
cudaError_t launch_gated(const void* a, const void* w, const int* mask,
                         float* out, int M, int K, int N, int bm, int bk,
                         cudaStream_t s) {
  const dim3 grid(N / BN, M / bm), block(BN);
  const T* A = static_cast<const T*>(a);
  const T* W = static_cast<const T*>(w);
#define GATED(BM_) \
  gated_mm_kernel<BM_, BN, T><<<grid, block, 0, s>>>(A, W, mask, out, K, N, bk)
  BM_CASES(GATED)
#undef GATED
  return cudaGetLastError();
}

// every tile the kernels take: bm in {8..128} (checked by the launchers),
// bn in {32, 64, 128}, bk a multiple of 32 (so of every KC)
bool bad_tiles(int M, int K, int N, int bm, int bk, int bn) {
  return bm <= 0 || M % bm || (bn != 32 && bn != 64 && bn != MAX_BN) ||
         bk <= 0 || bk % 32 || K % bk || N % bn;
}

}  // namespace

// Plain C interface (ctypes).  Pointers are device pointers; the stream is
// a cudaStream_t.  Returns the launch's cudaError_t (0 on success).
extern "C" int block_mm_skip(const void* a, const void* w, const void* kidx,
                             const void* colptr, void* out, int M, int K,
                             int N, int bm, int bk, int bn, int bf16,
                             void* stream) {
  if (bad_tiles(M, K, N, bm, bk, bn)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(kidx);
  const int* cp = static_cast<const int*>(colptr);
  float* o = static_cast<float*>(out);
#define ARGS a, w, ki, cp, o, M, K, N, bm, bk, s
  if (bf16) {
    if (bn == 32) return launch_skip<32, __nv_bfloat16>(ARGS);
    if (bn == 64) return launch_skip<64, __nv_bfloat16>(ARGS);
    return launch_skip<128, __nv_bfloat16>(ARGS);
  }
  if (bn == 32) return launch_skip<32, float>(ARGS);
  if (bn == 64) return launch_skip<64, float>(ARGS);
  return launch_skip<128, float>(ARGS);
#undef ARGS
}

extern "C" int block_mm_gated(const void* a, const void* w, const void* mask,
                              void* out, int M, int K, int N, int bm, int bk,
                              int bn, int bf16, void* stream) {
  if (bad_tiles(M, K, N, bm, bk, bn)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mk = static_cast<const int*>(mask);
  float* o = static_cast<float*>(out);
#define ARGS a, w, mk, o, M, K, N, bm, bk, s
  if (bf16) {
    if (bn == 32) return launch_gated<32, __nv_bfloat16>(ARGS);
    if (bn == 64) return launch_gated<64, __nv_bfloat16>(ARGS);
    return launch_gated<128, __nv_bfloat16>(ARGS);
  }
  if (bn == 32) return launch_gated<32, float>(ARGS);
  if (bn == 64) return launch_gated<64, float>(ARGS);
  return launch_gated<128, float>(ARGS);
#undef ARGS
}
