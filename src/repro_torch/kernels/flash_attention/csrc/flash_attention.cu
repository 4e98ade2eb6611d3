// Causal / non-causal flash attention for Hopper (sm_90a): kernel K4.
//
// out (B, S, H, D) f32 = softmax(q k^T / sqrt(D)) v for every (batch, head),
// q (B, S, H, D) and k, v (B, S, KV, D) in f32 or bf16, H a multiple of KV:
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
// SKIP, not GATE.  The numerics are the same (a gated tile changed nothing
// in the reference either).  Per key tile, as _flash_kernel: scores in f32
// times 1/sqrt(D), masked to -1e30 where the key is in the query's future,
// m_new = max(m, rowmax), corr = exp(m - m_new), p = exp(s - m_new), l =
// l*corr + rowsum(p) in f32, acc = acc*corr + p@v with p rounded to v's
// type before the product (bf16 inputs: p rounded to bf16, the products
// summed in f32), and out = acc / max(l, 1e-30) at the end.  The key tile
// (64 keys, 32 for D = 128) is the kernel's own; the wrapper's bq and bk
// only decide which shapes are legal, as the reference's assert does.
//
// What bounds it: at the serve prefill cell (B 8, S 512, H 14, KV 2, D 64,
// bf16, causal) the function moves 24 MB (q, k, v read once, f32 out
// written once: 7.2 us at 3.35 TB/s) and needs 3.8 GFLOP (3.8 us at the
// bf16 tensor-core rate), so its bound is the bytes.  This design does its
// products on the f32 FMA pipes (67 TFLOP/s, 56 us for the same work) from
// shared memory, so it is bound by FMA and shared-memory issue, far above
// the roofline.  What it does about it: each thread holds a 4 x (BK/16)
// tile of scores and a 4 x (D/16) tile of the accumulator, so every value
// read from shared memory feeds 4 to 8 FMAs (q and p are read as float4
// broadcasts); the causal loop ends at the diagonal (half the work of the
// full grid); and the query tiles with the most keys are scheduled first.
// mma.sync / wgmma, TMA and a pipelined ring of key tiles are later work.
//
// Thread block: 256 threads as 16 x 16 (ty, tx); thread (ty, tx) owns
// query rows ty*4 .. ty*4+3 of the tile, key columns tx + 16 j and
// accumulator columns tx + 16 c.  A row's 16 threads are one half-warp,
// so row max and row sum are shuffle reductions.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per thread block
constexpr int THREADS = 256;  // 16 x 16
constexpr int QS = BQ + 4;    // row stride of the k-major q and p tiles
constexpr float NEG_INF = -1e30f;

template <int D>
struct Tile {
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

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p as the reference hands it to the PV product: cast to v's type
template <typename T>
__device__ __forceinline__ float round_p(float p);
template <>
__device__ __forceinline__ float round_p<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// reductions over the 16 threads (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, s, h;  // elements; the last dimension is contiguous
};

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out, int S,
                 int H, int rep, Strides qs, Strides ks, Strides vs,
                 float scale) {
  using Geo = Tile<D>;
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qt[d * QS + r] = q0 + r < S ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
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
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < S;
      Kt[d * KS + c] = in ? to_f32(kb[(k0 + c) * ks.s + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(vb[(k0 + c) * vs.s + d]) : 0.f;
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
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = round_p<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
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
    float* o = out + (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[i][c] / den;
  }
}

struct Args {
  const void *q, *k, *v;
  float* out;
  int B, S, H, KV;
  Strides qs, ks, vs;
  cudaStream_t s;
};

template <int D, typename T, bool CAUSAL>
cudaError_t launch(const Args& x) {
  constexpr size_t smem = Tile<D>::SMEM;
  // above 48 KB of shared memory only after opting in, once per variant
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, T, CAUSAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid(x.B * x.H, (x.S + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_kernel<D, T, CAUSAL><<<grid, THREADS, smem, x.s>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k),
      static_cast<const T*>(x.v), x.out, x.S, x.H, x.H / x.KV, x.qs, x.ks,
      x.vs, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_causal(const Args& x, int causal) {
  return causal ? launch<D, T, true>(x) : launch<D, T, false>(x);
}

template <int D>
cudaError_t launch_type(const Args& x, int causal, int bf16) {
  return bf16 ? launch_causal<D, __nv_bfloat16>(x, causal)
              : launch_causal<D, float>(x, causal);
}

}  // namespace

// Plain C interface (ctypes).  Pointers are device pointers, the stream a
// cudaStream_t, strides in elements with the last dimension contiguous;
// out is a contiguous (B, S, H, D) f32 tensor.  D in {16, 32, 64, 128} and
// H a multiple of KV; any other shape returns cudaErrorInvalidValue.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int D,
                               long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh,
                               int causal, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV ||
      (long long)(S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const Args x{q, k, v, static_cast<float*>(out), B, S, H, KV,
               Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
               Strides{vsb, vss, vsh}, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch_type<16>(x, causal, bf16);
    case 32: return launch_type<32>(x, causal, bf16);
    case 64: return launch_type<64>(x, causal, bf16);
    case 128: return launch_type<128>(x, causal, bf16);
    default: return cudaErrorInvalidValue;
  }
}
