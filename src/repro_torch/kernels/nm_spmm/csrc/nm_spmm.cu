// N:M structured-sparse matmul for Hopper (sm_90a): kernel K3.
//
// out (M, N) f32 = A (M, K) @ W (K, N), with W stored N:M-compressed along
// K: of every m consecutive rows of a column only n are kept.  The kernel
// reads only the compressed arrays: w_vals (K/m*n, N) in A's type (f32 or
// bf16) and the CP offsets of the kept values within their m-group, either
// int8 (K/m*n, N) or bit-packed uint8 (K/m*n/per, N) with bits =
// ceil(log2 m), per = 8 / bits, and compressed row r at bit
// (r % per) * bits of byte r / per (sparsity/nm.py pack_offsets).
//
// Replaces the JAX package's kernels/nm_spmm/kernel.py: nm_spmm_kernel /
// _nm_kernel.  There each grid step streamed one compressed (bk/m*n, bn)
// weight tile into VMEM, decompressed it with a one-hot compare into a
// dense (bk, bn) tile and fed the MXU, carrying an f32 accumulator across
// the sequential k steps of the TPU grid.  Here each (i, j) output tile is
// one thread block that walks all of K itself (GPU blocks run in no
// order), one thread per output column, BM rows per thread in registers.
// Each step holds KC = G*m dense k rows: the thread loads its column's G*n
// kept values and offsets, decompresses every m-group into m dense values
// in registers with the same one-hot sum as the reference (so repeated
// offsets add, as there), and multiplies them with the A rows staged in
// shared memory.  No dense W exists anywhere: not in global memory, not
// in shared memory.  The step size is the kernel's own (the wrapper's bk
// only sets which shapes are legal, as the reference's asserts do); the
// last step may hold fewer groups.
//
// What bounds it: at the decode cells it serves (M = 8 rows, K, N in the
// thousands) every compressed weight byte is used M times, far below the
// ~20 FLOP/byte at which the card's f32 rate (67 TFLOP/s) would be the
// limit, so the bound is the compressed bytes over 3.35 TB/s: values,
// offsets (int8, or packed at bits/8 bytes each), A and the output.  The
// dense FMAs after decompression cost m/n times the useful ones and stay
// below that bound at M = 8.  The design keeps the bytes flowing: loads
// of the values and offsets are coalesced (neighbouring threads read
// neighbouring columns of one compressed row), A is staged k-major so the
// FMA loop reads it as float4 broadcasts, every loop has compile-time
// length, and the next step's A, values and offsets are loaded into
// registers while the current step's FMAs run.  No wgmma, TMA or
// multi-stage ring yet: a simple kernel that is right comes first.
//
// Thread block: BN threads (BN in {32, 64}), BM rows (8..64); n and m are
// template parameters (the reference's set: 2:4, 1:4, 2:6, 2:8, 4:8).  An
// output element's sum does not depend on the tile it belongs to, so the
// caller's bm = 128 and bn = 128 run as 64-wide tiles: the wider ones
// would hold 128 accumulators, spill, and double the variants to compile.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

// (m - 1).bit_length() for 2 <= m <= 8: the width of one CP offset
constexpr int offset_bits(int m) { return m <= 2 ? 1 : m <= 4 ? 2 : 3; }

template <int BM, int BN, int NN, int MM>
struct Geometry {
  static constexpr int BITS = offset_bits(MM);
  static constexpr int PER = 8 / BITS;  // packed offsets per byte
  // dense k rows per step, aimed at: fewer for tall or narrow tiles, so
  // that the next step's A slab takes at most 16 registers (BM * KC / BN)
  static constexpr int KCT = 16 * BN / BM < 32 ? 16 * BN / BM : 32;
  static constexpr int G0 = KCT / MM > 0 ? KCT / MM : 1;
  // a step's compressed rows fill whole bytes of packed offsets
  static constexpr int Q = PER / gcd_c(NN, PER);
  static constexpr int G = (G0 + Q - 1) / Q * Q;  // m-groups per step
  static constexpr int KC = G * MM;               // dense k rows per step
  static constexpr int R = G * NN;                // compressed rows per step
  static constexpr int RB = R / PER;              // packed offset bytes
  static constexpr int A_PER = (BM * KC + BN - 1) / BN;
};

// One step's inputs, in registers: A[row0 : row0+BM, k0 : k0+KC] (A_PER
// elements per thread, k fastest across threads) and this thread's column
// of the step's R compressed rows: values, and offsets (int8, one per
// row, or RB packed bytes).  Kept in the input types: converting here
// would wait on the loads that should be in flight during the FMAs.
template <int BM, int BN, int NN, int MM, typename T>
struct Slab {
  using Geo = Geometry<BM, BN, NN, MM>;
  T a[Geo::A_PER];
  T v[Geo::R];
  unsigned o[Geo::R];

  __device__ __forceinline__ void load(const T* __restrict__ A,
                                       const T* __restrict__ vals,
                                       const uint8_t* __restrict__ idx,
                                       int row0, int col, int step, int K,
                                       int N, int rows, bool packed) {
    const int tid = threadIdx.x;
    const int k0 = step * Geo::KC;
#pragma unroll
    for (int q = 0; q < Geo::A_PER; ++q) {
      const int e = tid + q * BN;
      const int kk = e % Geo::KC;
      a[q] = (e < BM * Geo::KC && k0 + kk < K)
                 ? A[(size_t)(row0 + e / Geo::KC) * K + k0 + kk]
                 : zero<T>();
    }
    const int r0 = step * Geo::R;
    const T* vp = vals + (size_t)r0 * N + col;
#pragma unroll
    for (int q = 0; q < Geo::R; ++q)
      v[q] = r0 + q < rows ? vp[(size_t)q * N] : zero<T>();
    if (packed) {
      const int b0 = r0 / Geo::PER;
      const uint8_t* ip = idx + (size_t)b0 * N + col;
#pragma unroll
      for (int q = 0; q < Geo::RB; ++q)
        o[q] = b0 + q < rows / Geo::PER ? ip[(size_t)q * N] : 0u;
    } else {
      const uint8_t* ip = idx + (size_t)r0 * N + col;
#pragma unroll
      for (int q = 0; q < Geo::R; ++q)
        o[q] = r0 + q < rows ? ip[(size_t)q * N] : 0u;
    }
  }

  // A goes in k-major (As[kk][r]) so the FMA loop reads rows as float4
  __device__ __forceinline__ void store_a(float (*As)[BM]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < Geo::A_PER; ++q) {
      const int e = tid + q * BN;
      if (e < BM * Geo::KC) As[e % Geo::KC][e / Geo::KC] = to_f32(a[q]);
    }
  }
};

// The FMAs of one step: each of its first `groups` m-groups decompressed
// into m dense values (the one-hot sum of its n kept values), then
// multiplied with the group's m staged A rows.
template <int BM, int BN, int NN, int MM, typename T>
__device__ __forceinline__ void nm_step(
    float (&acc)[BM], const float (*As)[BM],
    const T (&v)[Geometry<BM, BN, NN, MM>::R],
    const unsigned (&o)[Geometry<BM, BN, NN, MM>::R], int groups,
    bool packed) {
  using Geo = Geometry<BM, BN, NN, MM>;
  constexpr unsigned MASK = (1u << Geo::BITS) - 1u;
#pragma unroll
  for (int g = 0; g < Geo::G; ++g) {
    if (g < groups) {  // uniform: only the last step may hold fewer
      float w[MM];
#pragma unroll
      for (int p = 0; p < MM; ++p) w[p] = 0.f;
#pragma unroll
      for (int i = 0; i < NN; ++i) {
        const int q = g * NN + i;
        const unsigned off =
            packed ? (o[q / Geo::PER] >> ((q % Geo::PER) * Geo::BITS)) & MASK
                   : o[q];
        const float x = to_f32(v[q]);
#pragma unroll
        for (int p = 0; p < MM; ++p) w[p] += off == (unsigned)p ? x : 0.f;
      }
#pragma unroll
      for (int p = 0; p < MM; ++p) {
        const float* ar = As[g * MM + p];
#pragma unroll
        for (int r = 0; r < BM; r += 4) {
          const float4 av = *reinterpret_cast<const float4*>(ar + r);
          acc[r] = fmaf(av.x, w[p], acc[r]);
          acc[r + 1] = fmaf(av.y, w[p], acc[r + 1]);
          acc[r + 2] = fmaf(av.z, w[p], acc[r + 2]);
          acc[r + 3] = fmaf(av.w, w[p], acc[r + 3]);
        }
      }
    }
  }
}

// grid (N/BN, M/BM); block (j, i) computes out[i*BM : (i+1)*BM,
// j*BN : (j+1)*BN), walking all K/m groups G per step.
template <int BM, int BN, int NN, int MM, typename T>
__global__ void __launch_bounds__(BN)
nm_spmm_kernel(const T* __restrict__ a, const T* __restrict__ vals,
               const uint8_t* __restrict__ idx, float* __restrict__ out,
               int K, int N, int packed) {
  using Geo = Geometry<BM, BN, NN, MM>;
  __shared__ __align__(16) float As[Geo::KC][BM];
  const int col = blockIdx.x * BN + threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int groups = K / MM;
  const int rows = groups * NN;
  const int steps = (groups + Geo::G - 1) / Geo::G;
  const bool pk = packed != 0;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  Slab<BM, BN, NN, MM, T> slab;
  slab.load(a, vals, idx, row0, col, 0, K, N, rows, pk);
  for (int s = 0; s < steps; ++s) {
    slab.store_a(As);
    T v[Geo::R];
    unsigned o[Geo::R];
#pragma unroll
    for (int q = 0; q < Geo::R; ++q) {
      v[q] = slab.v[q];
      o[q] = slab.o[q];
    }
    __syncthreads();
    if (s + 1 < steps)  // in flight while this step's FMAs run
      slab.load(a, vals, idx, row0, col, s + 1, K, N, rows, pk);
    const int left = groups - s * Geo::G;
    nm_step<BM, BN, NN, MM, T>(acc, As, v, o,
                               left < Geo::G ? left : Geo::G, pk);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) out[(size_t)(row0 + r) * N + col] = acc[r];
}

struct Args {
  const void* a;
  const void* vals;
  const uint8_t* idx;
  float* out;
  int M, K, N, bm, packed;
  cudaStream_t s;
};

template <int NN, int MM, int BN, typename T>
cudaError_t launch_bm(const Args& x) {
  const dim3 grid(x.N / BN, x.M / x.bm), block(BN);
  const T* A = static_cast<const T*>(x.a);
  const T* V = static_cast<const T*>(x.vals);
#define NM_LAUNCH(BM_)                                                  \
  nm_spmm_kernel<BM_, BN, NN, MM, T><<<grid, block, 0, x.s>>>(          \
      A, V, x.idx, x.out, x.K, x.N, x.packed)
  switch (x.bm) {
    case 8: NM_LAUNCH(8); break;
    case 16: NM_LAUNCH(16); break;
    case 32: NM_LAUNCH(32); break;
    case 64: NM_LAUNCH(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef NM_LAUNCH
  return cudaGetLastError();
}

template <int NN, int MM, typename T>
cudaError_t launch_bn(const Args& x, int bn) {
  switch (bn) {
    case 32: return launch_bm<NN, MM, 32, T>(x);
    case 64: return launch_bm<NN, MM, 64, T>(x);
    default: return cudaErrorInvalidValue;
  }
}

template <int NN, int MM>
cudaError_t launch_nm(const Args& x, int bn, int bf16) {
  if (bf16) return launch_bn<NN, MM, __nv_bfloat16>(x, bn);
  return launch_bn<NN, MM, float>(x, bn);
}

}  // namespace

// Plain C interface (ctypes).  Pointers are device pointers; the stream is
// a cudaStream_t.  idx holds int8 offsets (packed = 0) or bit-packed uint8
// (packed = 1).  bm in {8, 16, 32, 64, 128} and bn in {32, 64, 128} must
// divide M and N.  Returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for shapes, tiles or (n, m) the kernel does not
// take.
extern "C" int nm_spmm(const void* a, const void* vals, const void* idx,
                       void* out, int M, int K, int N, int n, int m, int bm,
                       int bn, int packed, int bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bm <= 0 || bn <= 0 || m < 2 || m > 8 ||
      M % bm || N % bn || K % m || (bm != 128 && bm > 64) ||
      (bn != 128 && bn > 64))
    return cudaErrorInvalidValue;
  if (bm == 128) bm = 64;  // same sums, see the tile note at the top
  if (bn == 128) bn = 64;
  if (packed && ((K / m) * n) % (8 / offset_bits(m)))
    return cudaErrorInvalidValue;
  const Args x{a, vals, static_cast<const uint8_t*>(idx),
               static_cast<float*>(out), M, K, N, bm, packed,
               static_cast<cudaStream_t>(stream)};
  if (n == 2 && m == 4) return launch_nm<2, 4>(x, bn, bf16);
  if (n == 1 && m == 4) return launch_nm<1, 4>(x, bn, bf16);
  if (n == 2 && m == 6) return launch_nm<2, 6>(x, bn, bf16);
  if (n == 2 && m == 8) return launch_nm<2, 8>(x, bn, bf16);
  if (n == 4 && m == 8) return launch_nm<4, 8>(x, bn, bf16);
  return cudaErrorInvalidValue;
}
