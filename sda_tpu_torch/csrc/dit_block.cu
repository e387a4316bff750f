// The adaLN glue of DiT's transformer blocks (nn/dit.py: DiTBlock, FinalLayer), for Hopper
// (sm_90a): bf16 token rows (B, N, D), N tokens per sample, modulated by per-sample vectors.
//
// Replaces no TPU kernel: the JAX package has no DiT. The port ran this glue as PyTorch's chain of
// layer_norm, broadcast mul and add: per block two layer norms, four multiplies by (B, 1, D)
// vectors broadcast over the tokens (which run unvectorised), two modulate adds and two residual
// adds, about 22 activation-sized passes over device memory, each rounded to bf16.
//
//   norm_mod: h = LN(x) (1 + scale) + shift, LN without affine terms: population variance, eps as
//     given, statistics in float32. Writes h and each row's mean and rstd (float32).
//   gated norm_mod: x' = x + gate a (the attention branch's gated residual), then h = LN(x')
//     (1 + scale) + shift. Writes x', h, mean and rstd.
//   gated_add: y = x + gate m (the MLP branch's gated residual). Backward, dm = gate dy (x's
//     gradient is dy itself and takes no kernel).
//   norm_mod_bwd: g = dh (1 + scale), y = (x - mean) rstd, dx = rstd (g - mean(g) - y mean(g y))
//     plus the gradient ds that reached x' itself; gated, also da = gate dx.
// Every output is rounded to bf16 once, from float32.
//
// The modulation vectors' gradients (training only; the guided sampler's are never asked for) are
// sums over each sample's tokens: dshift = sum dh, dscale = sum dh y, dgate = sum dx a (or dy m).
// Each block sums a tile of kTileRows rows per column in a fixed order, then one thread per
// (vector, sample, column) sums the tiles in order. No atomics, so runs repeat bit for bit.
//
// What bounds them: bytes. They do about ten flops per element against 4-8 bytes, far under the
// card's 295 flops per byte, so the least time is the bytes over 3.35 TB/s, each input read once
// and each output written once. At DiT-XL/2's (28, 1024, 1152) an activation is 66.06 MB: the
// forward moves 2 of them (norm_mod), 4 (gated) and 3 (gated_add), 9 a block against about 22
// before; the input VJP 3 (norm_mod_bwd), 5 (gated) and 2 (gated_add_bwd). The design: a warp per
// row, which it reads once as 16-byte vectors (8 channels; neighbouring lanes on neighbouring
// addresses) and holds in registers (K vectors a lane) between the statistics and the output, so
// nothing is staged in shared memory and no row is read twice; the row's sums are warp shuffles.
// The vectors of a sample (2.3 KB each) are read by all its 1,024 rows and stay in L1 and L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;          // threads per block of the row kernels
constexpr int kWarps = kThreads / 32;  // rows per block
constexpr int kVec = 8;                // bf16 per 16-byte vector
constexpr int kMaxK = 8;               // vectors a lane holds: rows of at most 32 x 8 x 8 = 2048
constexpr int kTileRows = 32;          // rows per partial sum of the vectors' gradients
constexpr int kSumThreads = 128;       // threads per block of the partial sums

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Every input is read through the read-only path (ld.global.nc): no store of the kernel aliases
// it, so a lane's loads are issued back to back, ahead of its stores.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) h[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A modulation vector: sample b's D values start at p + b * stride.
struct Vector {
  const bf16* p;
  long long stride;
};

// -- Forward: a warp per row -----------------------------------------------------------------------
//
// Lane l holds the row's vectors l, l + 32, ..., l + 32 (K - 1) (those below D / 8).

template <int K, bool GATED>
__global__ void __launch_bounds__(kThreads) norm_mod_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, Vector gate, Vector shift, Vector scale,
    bf16* __restrict__ xp, bf16* __restrict__ h, float* __restrict__ mean, float* __restrict__ rstd,
    long long rows, int N, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vecs = D / kVec;
  const long long b = row / N;
  const size_t base = (size_t)row * D;
  const float inv_d = 1.0f / D;

  float v[K][kVec];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane >= vecs) continue;
    const int c = (k * 32 + lane) * kVec;
    load8(x + base + c, v[k]);
    if (GATED) {
      float g[kVec], w[kVec];
      load8(gate.p + b * gate.stride + c, g);
      load8(a + base + c, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = round_bf16(v[k][e] + g[e] * w[e]);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += v[k][e];
  }
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane >= vecs) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[k][e] - mu;
      sq += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane >= vecs) continue;
    const int c = (k * 32 + lane) * kVec;
    float sh[kVec], sc[kVec];
    load8(shift.p + b * shift.stride + c, sh);
    load8(scale.p + b * scale.stride + c, sc);
    if (GATED) store8(xp + base + c, v[k]);  // exact: v holds bf16 values
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[k][e] = (v[k][e] - mu) * rs * (1.0f + sc[e]) + sh[e];
    store8(h + base + c, v[k]);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// -- Backward: a warp per row ----------------------------------------------------------------------
//
// dx = rstd (g - mean(g) - y mean(g y)) + ds, g = dh (1 + scale), y = (x - mean) rstd; where
// GATED also da = gate dx (both from the float sum). ds may be null.

template <int K, bool GATED>
__global__ void __launch_bounds__(kThreads) norm_mod_bwd_kernel(
    const bf16* __restrict__ dh, const bf16* __restrict__ ds, const bf16* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ rstd, Vector scale, Vector gate,
    bf16* __restrict__ dx, bf16* __restrict__ da, long long rows, int N, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vecs = D / kVec;
  const long long b = row / N;
  const size_t base = (size_t)row * D;
  const float inv_d = 1.0f / D;
  const float mu = mean[row], rs = rstd[row];

  float y[K][kVec], g[K][kVec];
  float sg = 0.0f, sgy = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane >= vecs) continue;
    const int c = (k * 32 + lane) * kVec;
    float sc[kVec];
    load8(x + base + c, y[k]);
    load8(dh + base + c, g[k]);
    load8(scale.p + b * scale.stride + c, sc);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      y[k][e] = (y[k][e] - mu) * rs;
      g[k][e] *= 1.0f + sc[e];
      sg += g[k][e];
      sgy += g[k][e] * y[k][e];
    }
  }
  const float mg = warp_sum(sg) * inv_d, mgy = warp_sum(sgy) * inv_d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane >= vecs) continue;
    const int c = (k * 32 + lane) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) g[k][e] = rs * (g[k][e] - mg - y[k][e] * mgy);
    if (ds != nullptr) {
      float w[kVec];
      load8(ds + base + c, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) g[k][e] += w[e];
    }
    store8(dx + base + c, g[k]);
    if (GATED) {
      float w[kVec];
      load8(gate.p + b * gate.stride + c, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) w[e] *= g[k][e];
      store8(da + base + c, w);
    }
  }
}

// -- Gated residual: a thread per vector -----------------------------------------------------------
//
// out = x + gate m where RESIDUAL (the forward), out = gate m otherwise (dm = gate dy).

template <bool RESIDUAL>
__global__ void __launch_bounds__(kThreads) gated_add_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ m, Vector gate, bf16* __restrict__ out,
    long long items, int vecs, int N) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= items) return;
  const long long row = idx / vecs;
  const int c = (int)(idx - row * vecs) * kVec;
  const size_t at = (size_t)idx * kVec;
  float w[kVec], g[kVec], o[kVec];
  load8(m + at, w);
  load8(gate.p + (row / N) * gate.stride + c, g);
  if (RESIDUAL) {
    load8(x + at, o);
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] += g[e] * w[e];
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = g[e] * w[e];
  }
  store8(out + at, o);
}

// -- The vectors' gradients: partial sums over tiles of rows, then the tiles in order --------------
//
// Block (v, t, b) takes kSumThreads column vectors of tile t of sample b. Slot 0: sum dh; slot 1:
// sum dh y (y from x, mean, rstd); slot 2: sum g a. dh (and x) or g (and a) may be null, and that
// slot is left unwritten. part[((b tiles + t) 3 + slot) D + column].

__global__ void __launch_bounds__(kSumThreads) vector_sums_kernel(
    const bf16* __restrict__ dh, const bf16* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const bf16* __restrict__ g, const bf16* __restrict__ a,
    float* __restrict__ part, int N, int D) {
  const int v = blockIdx.x * kSumThreads + threadIdx.x;
  if (v * kVec >= D) return;
  const int c = v * kVec, t = blockIdx.y, tiles = gridDim.y;
  const long long b = blockIdx.z, r0 = b * N + (long long)t * kTileRows;
  const int count = min(kTileRows, N - t * kTileRows);
  float s0[kVec], s1[kVec], s2[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) s0[e] = s1[e] = s2[e] = 0.0f;
  for (int r = 0; r < count; ++r) {
    const size_t at = (size_t)(r0 + r) * D + c;
    float w[kVec], u[kVec];
    if (dh != nullptr) {
      const float mu = mean[r0 + r], rs = rstd[r0 + r];
      load8(dh + at, w);
      load8(x + at, u);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s0[e] += w[e];
        s1[e] += w[e] * ((u[e] - mu) * rs);
      }
    }
    if (g != nullptr) {
      load8(g + at, w);
      load8(a + at, u);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s2[e] += w[e] * u[e];
    }
  }
  float* out = part + ((size_t)b * tiles + t) * 3 * D + c;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (dh != nullptr) {
      out[e] = s0[e];
      out[D + e] = s1[e];
    }
    if (g != nullptr) out[2 * D + e] = s2[e];
  }
}

// dvec[slot][b][column] = sum over t of part[b][t][slot][column], t in order, slots first..last - 1.
__global__ void __launch_bounds__(kThreads) sum_tiles_kernel(const float* __restrict__ part,
                                                             float* __restrict__ dvec, int B,
                                                             int tiles, int D, int first,
                                                             int last) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long per_slot = (long long)B * D;
  if (idx >= (last - first) * per_slot) return;
  const int slot = first + (int)(idx / per_slot);
  const long long rest = idx % per_slot, b = rest / D, c = rest - b * D;
  float total = 0.0f;
  for (int t = 0; t < tiles; ++t) total += part[((b * tiles + t) * 3 + slot) * D + c];
  dvec[slot * per_slot + rest] = total;
}

// Enqueues the partial sums and their sum into dvec (3 x B x D floats; part holds B x tiles x 3 x
// D), slots first..last - 1.
cudaError_t vector_sums(const bf16* dh, const bf16* x, const float* mean, const float* rstd,
                        const bf16* g, const bf16* a, float* part, float* dvec, int B, int N,
                        int D, int first, int last, cudaStream_t st) {
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const dim3 grid((D / kVec + kSumThreads - 1) / kSumThreads, tiles, B);
  vector_sums_kernel<<<grid, kSumThreads, 0, st>>>(dh, x, mean, rstd, g, a, part, N, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = (long long)(last - first) * B * D;
  sum_tiles_kernel<<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, dvec, B, tiles, D, first, last);
  return cudaGetLastError();
}

// The lanes' vector count K for rows of D: ceil(D / 8 / 32), 1..kMaxK; 0 where D is refused.
int lane_vectors(int D) {
  if (D <= 0 || D % kVec != 0 || D > 32 * kVec * kMaxK) return 0;
  return (D / kVec + 31) / 32;
}

unsigned row_blocks(long long rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

#define SDA_DIT_BY_K(K, CALL) \
  switch (K) {                \
    case 1: CALL(1); break;   \
    case 2: CALL(2); break;   \
    case 3: CALL(3); break;   \
    case 4: CALL(4); break;   \
    case 5: CALL(5); break;   \
    case 6: CALL(6); break;   \
    case 7: CALL(7); break;   \
    case 8: CALL(8); break;   \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// Each launcher enqueues its kernels on `stream` without synchronising and returns
// cudaGetLastError() as an int (0 = launched). Tensors are bf16 but mean, rstd, part and dvec
// (float32); rows = B N rows of D channels, contiguous; D a multiple of 8 up to 2048, else refused.
// A modulation vector is given by its pointer and its row stride in elements (its channels
// contiguous); every pointer and stride is aligned to 16 bytes. part and dvec (B x ceil(N / 32) x 3
// x D and 3 x B x D floats) are null where the vectors' gradients are not wanted.

int sda_dit_norm_mod(const void* x, const void* shift, long long shift_stride, const void* scale,
                     long long scale_stride, void* h, float* mean, float* rstd, int B, int N,
                     int D, float eps, void* stream) {
  const int K = lane_vectors(D);
  const long long rows = (long long)B * N;
  const Vector none{nullptr, 0}, sh{(const bf16*)shift, shift_stride}, sc{(const bf16*)scale, scale_stride};
  cudaStream_t st = (cudaStream_t)stream;
#define SDA_CALL(k)                                                                              \
  norm_mod_kernel<k, false><<<row_blocks(rows), kThreads, 0, st>>>(                              \
      (const bf16*)x, nullptr, none, sh, sc, nullptr, (bf16*)h, mean, rstd, rows, N, D, eps)
  SDA_DIT_BY_K(K, SDA_CALL)
#undef SDA_CALL
  return (int)cudaGetLastError();
}

int sda_dit_gated_norm_mod(const void* x, const void* a, const void* gate, long long gate_stride,
                           const void* shift, long long shift_stride, const void* scale,
                           long long scale_stride, void* xp, void* h, float* mean, float* rstd,
                           int B, int N, int D, float eps, void* stream) {
  const int K = lane_vectors(D);
  const long long rows = (long long)B * N;
  const Vector gt{(const bf16*)gate, gate_stride}, sh{(const bf16*)shift, shift_stride},
      sc{(const bf16*)scale, scale_stride};
  cudaStream_t st = (cudaStream_t)stream;
#define SDA_CALL(k)                                                                              \
  norm_mod_kernel<k, true><<<row_blocks(rows), kThreads, 0, st>>>(                               \
      (const bf16*)x, (const bf16*)a, gt, sh, sc, (bf16*)xp, (bf16*)h, mean, rstd, rows, N, D,   \
      eps)
  SDA_DIT_BY_K(K, SDA_CALL)
#undef SDA_CALL
  return (int)cudaGetLastError();
}

// dx is required (the vectors' gradients read it through dh and x only).
int sda_dit_norm_mod_bwd(const void* dh, const void* x, const float* mean, const float* rstd,
                         const void* scale, long long scale_stride, void* dx, float* part,
                         float* dvec, int B, int N, int D, void* stream) {
  const int K = lane_vectors(D);
  if ((part == nullptr) != (dvec == nullptr)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  const Vector none{nullptr, 0}, sc{(const bf16*)scale, scale_stride};
  cudaStream_t st = (cudaStream_t)stream;
#define SDA_CALL(k)                                                                              \
  norm_mod_bwd_kernel<k, false><<<row_blocks(rows), kThreads, 0, st>>>(                          \
      (const bf16*)dh, nullptr, (const bf16*)x, mean, rstd, sc, none, (bf16*)dx, nullptr, rows,  \
      N, D)
  SDA_DIT_BY_K(K, SDA_CALL)
#undef SDA_CALL
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dvec == nullptr) return (int)err;
  return (int)vector_sums((const bf16*)dh, (const bf16*)x, mean, rstd, nullptr, nullptr, part, dvec,
                          B, N, D, 0, 2, st);
}

// x is x' (the forward's output), ds its gradient (may be null); a is read only for dvec (dgate =
// sum dx a, from the rounded dx).
int sda_dit_gated_norm_mod_bwd(const void* dh, const void* ds, const void* x, const float* mean,
                               const float* rstd, const void* scale, long long scale_stride,
                               const void* gate, long long gate_stride, const void* a, void* dx,
                               void* da, float* part, float* dvec, int B, int N, int D,
                               void* stream) {
  const int K = lane_vectors(D);
  if ((part == nullptr) != (dvec == nullptr) || (dvec != nullptr && a == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)B * N;
  const Vector sc{(const bf16*)scale, scale_stride}, gt{(const bf16*)gate, gate_stride};
  cudaStream_t st = (cudaStream_t)stream;
#define SDA_CALL(k)                                                                              \
  norm_mod_bwd_kernel<k, true><<<row_blocks(rows), kThreads, 0, st>>>(                           \
      (const bf16*)dh, (const bf16*)ds, (const bf16*)x, mean, rstd, sc, gt, (bf16*)dx, (bf16*)da, \
      rows, N, D)
  SDA_DIT_BY_K(K, SDA_CALL)
#undef SDA_CALL
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dvec == nullptr) return (int)err;
  return (int)vector_sums((const bf16*)dh, (const bf16*)x, mean, rstd, (const bf16*)dx,
                          (const bf16*)a, part, dvec, B, N, D, 0, 3, st);
}

int sda_dit_gated_add(const void* x, const void* m, const void* gate, long long gate_stride,
                      void* y, int B, int N, int D, void* stream) {
  if (lane_vectors(D) == 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * N * (D / kVec);
  gated_add_kernel<true><<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>((const bf16*)x, (const bf16*)m,
                                                   Vector{(const bf16*)gate, gate_stride},
                                                   (bf16*)y, items, D / kVec, N);
  return (int)cudaGetLastError();
}

// dm = gate dy; dvec's slot 2 = sum dy m where dvec is set (m read only then).
int sda_dit_gated_add_bwd(const void* dy, const void* m, const void* gate, long long gate_stride,
                          void* dm, float* part, float* dvec, int B, int N, int D, void* stream) {
  if (lane_vectors(D) == 0 || (part == nullptr) != (dvec == nullptr)) return (int)cudaErrorInvalidValue;
  if (dvec != nullptr && m == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = (long long)B * N * (D / kVec);
  gated_add_kernel<false><<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      nullptr, (const bf16*)dy, Vector{(const bf16*)gate, gate_stride}, (bf16*)dm, items, D / kVec, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dvec == nullptr) return (int)err;
  return (int)vector_sums(nullptr, nullptr, nullptr, nullptr, (const bf16*)dy, (const bf16*)m, part,
                          dvec, B, N, D, 2, 3, st);
}

}  // extern "C"
