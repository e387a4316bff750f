// The glue between the convolutions of the U-Net's residual blocks, for Hopper (sm_90a): bf16,
// channels-last (NHWC), written straight into the wrap-padded input of the next convolution.
//
// Replaces no TPU kernel. The JAX package (sda_tpu/nn/unet.py, nn/layers.py) leaves this glue to
// XLA, which fuses it around its convolutions. The port ran it in PyTorch, channel-first: per block
// forward about 30 elementwise kernels (modulation add, float32 up-cast, var_mean, normalise, cast
// back, two circular pads, SiLU, residual add, the convolutions' bias adds) and cuDNN's four
// NCHW <-> NHWC transposes, about 35 activation-sized passes over device memory.
//
//   norm_pad: P = pad(up(layer_norm_C(s + m))), where s = x + (r + b) is the residual stream with
//     the previous convolution's output r and bias b folded in (or s = x + b, or s = x); b is the
//     float32 parameter, rounded to bf16 as the convolution's own bias add rounds it. Writes s
//     (where anything is added), P, and each pixel's mean and rstd in float32. Population variance,
//     eps as given, statistics in float32, every sum rounded to bf16 where PyTorch rounds it.
//   act_pad: Q = pad(act(v)), with v = x + (r + b) or v = bf16(x) + b; act is SiLU or the identity.
//     x may be float32 or bf16 with any strides (the U-Net's NCHW input, read once, cast and
//     padded in one pass); it writes v where asked (the skip connection).
//   pad wraps circularly, lo before and hi after, on each axis; up repeats each pixel up times.
//
// Backward: fold the halo of dP / dQ back onto the pixels it was copied from (a float32 sum over
// the 1 to 4 positions that hold each pixel, 4 up to 9 with up = 2), then the layer norm's
// backward from the saved s, m, mean and rstd, or SiLU' from the saved x and b, plus the gradient
// that reached s itself. norm_pad's dm (the modulation's gradient, training only) is a sum over
// each image's pixels in two passes: each block sums its tile of pixels in a fixed order, then one
// thread per (n, c) sums the tiles in order. No atomics, so runs repeat bit for bit.
//
// What bounds them: bytes. They do a few flops per element against 4-8 bytes, far under the
// card's 295 flops per byte, so the least time is the bytes over 3.35 TB/s. The forward of a
// block moves about 6 activation sizes here (norm_pad reads x and r and writes s and P; act_pad
// reads a and writes Q) and the backward 7 (dP, s, ds in and dx out; dQ, a in and da out),
// against about 35 and 70 before. Each input is read once and each output written once, in
// vectors of up to 16 bytes along C (8 channels), every thread of a block on neighbouring
// addresses; the halo costs only its own writes (norm_pad scatters each pixel to every position
// that holds it) or its own reads (act_pad and the folds gather). norm_pad stages a tile of
// pixels (they lie side by side in NHWC) in shared memory, where a warp per pixel reduces it, so
// the pixel is read from device memory once; act_pad takes a row per block, with no division
// per element beyond the channel vector's. On the H100 they reach 39-71% of the bound at
// unet_0's shapes (PERF.md, section 6): a thread keeps one vector in flight at a time, and a
// fourfold unroll of the item loops did not help (act_pad slowed from 0.105 to 0.131 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;  // norm_pad: a warp reduces one pixel at a time

// One axis of the padded output: `n` source pixels repeated `up` times, then wrapped with `lo`
// before and `hi` after (lo, hi <= n up), `out` = n up + lo + hi positions.
struct Axis {
  int n, up, lo, out;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float load_one(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

template <int V> struct Pack;
template <> struct Pack<8> { typedef uint4 T; };
template <> struct Pack<1> { typedef unsigned short T; };

template <int V>
__device__ __forceinline__ void load(const bf16* p, float* v) {
  const typename Pack<V>::T raw = *reinterpret_cast<const typename Pack<V>::T*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = __bfloat162float(h[e]);
}

template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = p[e];
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float* v) {
  typename Pack<V>::T raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) h[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<typename Pack<V>::T*>(p) = raw;
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
#pragma unroll
  for (int e = 0; e < V; ++e) p[e] = v[e];
}

// v <- x + (r + b), or x + b where r is null, with b (float32) rounded to bf16 and each sum
// rounded to bf16, as PyTorch's bf16 adds of a bias cast to bf16 round them; x is already in v,
// as float.
template <int V>
__device__ __forceinline__ void residual(float* v, const bf16* r, const float* b, size_t at, int c) {
  if (r == nullptr && b == nullptr) return;
  float t[V], w[V];
  if (r != nullptr) {
    load<V>(r + at, t);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = v[e];
  }
  if (b != nullptr) {
    load<V>(b + c, w);
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = round_bf16(t[e] + round_bf16(w[e]));
  }
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = r != nullptr ? round_bf16(v[e] + t[e]) : t[e];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- norm_pad ------------------------------------------------------------------------------------
//
// Grid (tiles, N), kThreads threads: block (t, n) takes the `tile` pixels from t tile on of image
// n, which lie side by side in memory (tile C <= kTile elements). All threads load and store the
// tile as vectors of V channels, coalesced; a warp per pixel reduces it from shared memory.

constexpr int kTile = 6144;      // elements of one block's tile (64 pixels of 96 channels)
constexpr int kMaxPixels = 256;  // pixels of one block's tile

// Every output position (oh, ow) that holds source pixel (i, j): up copies per axis, each also
// wrapped; f(offset of (oh, ow) in pixels from image n's first output pixel).
template <typename F>
__device__ __forceinline__ void for_each_target(int i, int j, Axis ah, Axis aw, F f) {
  const int mh = ah.n * ah.up, mw = aw.n * aw.up;
  for (int qh = 0; qh < ah.up; ++qh) {
    for (int oh = ah.lo + i * ah.up + qh - mh; oh < ah.out; oh += mh) {
      if (oh < 0) continue;
      for (int qw = 0; qw < aw.up; ++qw) {
        for (int ow = aw.lo + j * aw.up + qw - mw; ow < aw.out; ow += mw) {
          if (ow >= 0) f(oh * aw.out + ow);
        }
      }
    }
  }
}

// Sum of g over every position of the padded gradient that holds pixel (i, j), vector at c.
template <int V>
__device__ __forceinline__ void fold(const bf16* g, int n, int i, int j, int c, int C, Axis ah,
                                     Axis aw, float* acc) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  const bf16* image = g + (size_t)n * ah.out * aw.out * C + c;
  for_each_target(i, j, ah, aw, [&](int o) {
    float v[V];
    load<V>(image + (size_t)o * C, v);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += v[e];
  });
}

template <int V>
__global__ void __launch_bounds__(kThreads) norm_pad_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ r, const float* __restrict__ b,
    const bf16* __restrict__ m, bf16* __restrict__ s, bf16* __restrict__ out,
    float* __restrict__ mean, float* __restrict__ rstd, int H, int W, int C, Axis ah, Axis aw,
    int tile, float eps) {
  __shared__ __align__(16) bf16 u[kTile];
  __shared__ float stat[2][kMaxPixels];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.y, pixels = H * W, p0 = blockIdx.x * tile;
  const int count = min(tile, pixels - p0), items = count * (C / V);
  const size_t base = ((size_t)n * pixels + p0) * C;

  // s = x + (r + b), then u = s + m, into shared memory.
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int e = idx * V, c = e % C;
    float v[V];
    load<V>(x + base + e, v);
    residual<V>(v, r, b, base + e, c);
    if (s != nullptr) store<V>(s + base + e, v);
    if (m != nullptr) {
      float w[V];
      load<V>(m + (size_t)n * C + c, w);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = round_bf16(v[k] + w[k]);
    }
    store<V>(u + e, v);
  }
  __syncthreads();

  // Each pixel's mean and rstd, two passes over its channels.
  const float inv_c = 1.0f / C;
  for (int t = warp; t < count; t += kWarps) {
    const bf16* row = u + t * C;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += __bfloat162float(row[c]);
    const float mu = warp_sum(sum) * inv_c;
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      sq += d * d;
    }
    const float rs = rsqrtf(warp_sum(sq) * inv_c + eps);
    if (lane == 0) {
      stat[0][t] = mu;
      stat[1][t] = rs;
      mean[(size_t)n * pixels + p0 + t] = mu;
      rstd[(size_t)n * pixels + p0 + t] = rs;
    }
  }
  __syncthreads();

  // Normalise and write each vector to every position that holds its pixel.
  bf16* image = out + (size_t)n * ah.out * aw.out * C;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int e = idx * V, t = e / C, c = e - t * C, p = p0 + t, i = p / W, j = p - i * W;
    const float mu = stat[0][t], rs = stat[1][t];
    float v[V];
    load<V>(u + e, v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = (v[k] - mu) * rs;
    for_each_target(i, j, ah, aw, [&](int o) { store<V>(image + (size_t)o * C + c, v); });
  }
}

// dx = ds + LN'(fold(dP)); where dm_part is set, block (t, n) also writes the sum over its tile
// of LN'(fold(dP)) at dm_part[(n tiles + t) C + c].
template <int V>
__global__ void __launch_bounds__(kThreads) norm_pad_bwd_kernel(
    const bf16* __restrict__ dp, const bf16* __restrict__ ds, const bf16* __restrict__ s,
    const bf16* __restrict__ m, const float* __restrict__ mean, const float* __restrict__ rstd,
    bf16* __restrict__ dx, float* __restrict__ dm_part, int H, int W, int C, Axis ah, Axis aw,
    int tile) {
  __shared__ __align__(16) float g[kTile];
  __shared__ __align__(16) bf16 u[kTile];
  __shared__ float stat[4][kMaxPixels];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.y, pixels = H * W, p0 = blockIdx.x * tile;
  const int count = min(tile, pixels - p0), items = count * (C / V);
  const size_t base = ((size_t)n * pixels + p0) * C;

  // u = s + m and g = fold(dP), into shared memory.
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int e = idx * V, t = e / C, c = e - t * C, p = p0 + t, i = p / W, j = p - i * W;
    float v[V];
    load<V>(s + base + e, v);
    if (m != nullptr) {
      float w[V];
      load<V>(m + (size_t)n * C + c, w);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = round_bf16(v[k] + w[k]);
    }
    store<V>(u + e, v);
    fold<V>(dp, n, i, j, c, C, ah, aw, v);
    store<V>(g + e, v);
  }
  __syncthreads();

  // Each pixel's mean over channels of g and of g y, y = (u - mean) rstd.
  const float inv_c = 1.0f / C;
  for (int t = warp; t < count; t += kWarps) {
    const float mu = mean[(size_t)n * pixels + p0 + t], rs = rstd[(size_t)n * pixels + p0 + t];
    float sg = 0.0f, sgy = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float y = (__bfloat162float(u[t * C + c]) - mu) * rs;
      sg += g[t * C + c];
      sgy += g[t * C + c] * y;
    }
    sg = warp_sum(sg);
    sgy = warp_sum(sgy);
    if (lane == 0) {
      stat[0][t] = mu;
      stat[1][t] = rs;
      stat[2][t] = sg * inv_c;
      stat[3][t] = sgy * inv_c;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int e = idx * V, t = e / C;
    const float mu = stat[0][t], rs = stat[1][t], mg = stat[2][t], mgy = stat[3][t];
    float y[V], d[V];
    load<V>(u + e, y);
    load<V>(g + e, d);
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = rs * (d[k] - mg - (y[k] - mu) * rs * mgy);
    if (dm_part != nullptr) store<V>(g + e, d);
    if (ds != nullptr) {
      float w[V];
      load<V>(ds + base + e, w);
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] += w[k];
    }
    store<V>(dx + base + e, d);
  }

  // The tile's sum of LN'(fold(dP)) per channel, pixels in order.
  if (dm_part == nullptr) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float total = 0.0f;
    for (int t = 0; t < count; ++t) total += g[t * C + c];
    dm_part[((size_t)n * gridDim.x + blockIdx.x) * C + c] = total;
  }
}

// dm[n, c] = sum over t of part[n, t, c], t in order.
__global__ void __launch_bounds__(kThreads) sum_tiles_kernel(const float* __restrict__ part,
                                                             float* __restrict__ dm, int N,
                                                             int tiles, int C) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= N * C) return;
  const int n = idx / C, c = idx - n * C;
  float total = 0.0f;
  for (int t = 0; t < tiles; ++t) total += part[((size_t)n * tiles + t) * C + c];
  dm[idx] = total;
}

// -- act_pad -------------------------------------------------------------------------------------
//
// Forward: a block per output row (n, oh), threads over its vectors of V channels. Backward: a
// block per source row (n, i). x and dx are addressed by their strides (elements; the channel
// stride is 1 wherever V > 1).

struct Strides {
  long long n, h, w, c;
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// The source index of output position o along an axis without upsampling (lo, hi <= n).
__device__ __forceinline__ int wrap(int o, Axis a) {
  const int u = o - a.lo;
  return u < 0 ? u + a.n : (u >= a.n ? u - a.n : u);
}

template <int V, typename TX>
__device__ __forceinline__ void load_strided(const TX* p, long long stride, float* v) {
  if (V == 1 || stride != 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = load_one(p + e * stride);
  } else {
    load<V>(p, v);
  }
}

template <int V, typename TX>
__global__ void __launch_bounds__(kThreads) act_pad_kernel(
    const TX* __restrict__ x, Strides sx, const bf16* __restrict__ r, const float* __restrict__ b,
    bf16* __restrict__ s, bf16* __restrict__ out, int H, int W, int C, Axis ah, Axis aw, int act) {
  const int n = blockIdx.x / ah.out, oh = blockIdx.x - n * ah.out, i = wrap(oh, ah);
  const int vecs = C / V, items = aw.out * vecs;
  const bool interior = oh == ah.lo + i;
  const TX* xrow = x + n * sx.n + i * sx.h;
  const size_t row = ((size_t)n * H + i) * W * C;
  bf16* orow = out + (size_t)blockIdx.x * aw.out * C;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int ow = idx / vecs, c = (idx - ow * vecs) * V, j = wrap(ow, aw);
    float v[V];
    load_strided<V>(xrow + j * sx.w + c * sx.c, sx.c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = round_bf16(v[e]);
    const size_t at = row + (size_t)j * C + c;
    residual<V>(v, r, b, at, c);
    if (s != nullptr && interior && ow == aw.lo + j) store<V>(s + at, v);
    if (act) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = silu(v[e]);
    }
    store<V>(orow + (size_t)ow * C + c, v);
  }
}

// dx = ds + fold(dq) act'(v), v recomputed from x and b.
template <int V, typename TX>
__global__ void __launch_bounds__(kThreads) act_pad_bwd_kernel(
    const bf16* __restrict__ dq, const bf16* __restrict__ ds, const TX* __restrict__ x, Strides sx,
    const float* __restrict__ b, TX* __restrict__ dx, Strides sd, int H, int W, int C, Axis ah,
    Axis aw, int act) {
  const int n = blockIdx.x / H, i = blockIdx.x - n * H;
  const int vecs = C / V, items = W * vecs;
  const size_t row = ((size_t)n * H + i) * W * C;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int j = idx / vecs, c = (idx - j * vecs) * V;
    float g[V];
    fold<V>(dq, n, i, j, c, C, ah, aw, g);
    if (act) {
      float v[V];
      load_strided<V>(x + n * sx.n + i * sx.h + j * sx.w + c * sx.c, sx.c, v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = round_bf16(v[e]);
      residual<V>(v, nullptr, b, 0, c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float sig = 1.0f / (1.0f + expf(-v[e]));
        g[e] *= sig * (1.0f + v[e] * (1.0f - sig));
      }
    }
    if (ds != nullptr) {
      float w[V];
      load<V>(ds + row + (size_t)j * C + c, w);
#pragma unroll
      for (int e = 0; e < V; ++e) g[e] += w[e];
    }
    TX* pd = dx + n * sd.n + i * sd.h + j * sd.w + c * sd.c;
    if (V == 1 || sd.c != 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) store_one(pd + e * sd.c, g[e]);
    } else {
      store<V>(pd, g);
    }
  }
}


template <int V, typename TX>
void act_pad_launch(const void* x, Strides sx, const void* r, const void* b, void* s, void* out,
                    int N, int H, int W, int C, Axis ah, Axis aw, int act, cudaStream_t st) {
  act_pad_kernel<V, TX><<<N * ah.out, kThreads, 0, st>>>(
      (const TX*)x, sx, (const bf16*)r, (const float*)b, (bf16*)s, (bf16*)out, H, W, C, ah, aw, act);
}

template <int V, typename TX>
void act_pad_bwd_launch(const void* dq, const void* ds, const void* x, Strides sx, const void* b,
                        void* dx, Strides sd, int N, int H, int W, int C, Axis ah, Axis aw,
                        int act, cudaStream_t st) {
  act_pad_bwd_kernel<V, TX><<<N * H, kThreads, 0, st>>>(
      (const bf16*)dq, (const bf16*)ds, (const TX*)x, sx, (const float*)b, (TX*)dx, sd, H, W, C, ah,
      aw, act);
}

}  // namespace

extern "C" {

// Each launcher enqueues its kernels on `stream` without synchronising and returns
// cudaGetLastError() as an int (0 = launched). `vec` is the channel vector width (8, dividing C,
// the pointers it reads and writes along C aligned to 16 bytes and x bf16; else 1); any other
// value is refused, as is a norm_pad `tile` (pixels per block) above kMaxPixels or of more than kTile
// elements. A null r, b, m, s or ds is absent; b (C) is float32, every other tensor but the
// statistics and act_pad's x and dx bf16. An axis is given as (up, lo, out) with its source
// length from H or W; act_pad's axes take no upsampling and lo, hi <= H, W.

int sda_norm_pad(const void* x, const void* r, const void* b, const void* m, void* s, void* out,
                 float* mean, float* rstd, int N, int H, int W, int C, int up_h, int lo_h,
                 int out_h, int up_w, int lo_w, int out_w, int vec, int tile, float eps,
                 void* stream) {
  if (C % vec != 0 || tile <= 0 || tile > kMaxPixels || tile * C > kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const Axis ah{H, up_h, lo_h, out_h}, aw{W, up_w, lo_w, out_w};
  const dim3 grid((H * W + tile - 1) / tile, N);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *bx = (const bf16*)x, *br = (const bf16*)r, *bm = (const bf16*)m;
  const float* bb = (const float*)b;
  bf16 *bs = (bf16*)s, *bo = (bf16*)out;
  switch (vec) {
    case 8: norm_pad_kernel<8><<<grid, kThreads, 0, st>>>(bx, br, bb, bm, bs, bo, mean, rstd, H, W, C, ah, aw, tile, eps); break;
    case 1: norm_pad_kernel<1><<<grid, kThreads, 0, st>>>(bx, br, bb, bm, bs, bo, mean, rstd, H, W, C, ah, aw, tile, eps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dm_part holds N x tiles x C floats and dm N x C; both null where dm is not wanted.
int sda_norm_pad_bwd(const void* dp, const void* ds, const void* s, const void* m,
                     const float* mean, const float* rstd, void* dx, float* dm_part, float* dm,
                     int N, int H, int W, int C, int up_h, int lo_h, int out_h, int up_w,
                     int lo_w, int out_w, int vec, int tile, void* stream) {
  if (C % vec != 0 || tile <= 0 || tile > kMaxPixels || tile * C > kTile) {
    return (int)cudaErrorInvalidValue;
  }
  if ((dm_part == nullptr) != (dm == nullptr)) return (int)cudaErrorInvalidValue;
  const Axis ah{H, up_h, lo_h, out_h}, aw{W, up_w, lo_w, out_w};
  const int tiles = (H * W + tile - 1) / tile;
  const dim3 grid(tiles, N);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *bp = (const bf16*)dp, *bd = (const bf16*)ds, *bs = (const bf16*)s, *bm = (const bf16*)m;
  bf16* bx = (bf16*)dx;
  switch (vec) {
    case 8: norm_pad_bwd_kernel<8><<<grid, kThreads, 0, st>>>(bp, bd, bs, bm, mean, rstd, bx, dm_part, H, W, C, ah, aw, tile); break;
    case 1: norm_pad_bwd_kernel<1><<<grid, kThreads, 0, st>>>(bp, bd, bs, bm, mean, rstd, bx, dm_part, H, W, C, ah, aw, tile); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (dm != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_tiles_kernel<<<(N * C + kThreads - 1) / kThreads, kThreads, 0, st>>>(dm_part, dm, N, tiles, C);
  }
  return (int)cudaGetLastError();
}

// x is float32 where x_f32, else bf16; its strides are in elements, the channel stride 1 where
// vec > 1.
int sda_act_pad(const void* x, int x_f32, long long sxn, long long sxh, long long sxw,
                long long sxc, const void* r, const void* b, void* s, void* out, int N, int H,
                int W, int C, int lo_h, int out_h, int lo_w, int out_w, int vec, int act,
                void* stream) {
  if (C % vec != 0 || (vec > 1 && sxc != 1)) return (int)cudaErrorInvalidValue;
  const Axis ah{H, 1, lo_h, out_h}, aw{W, 1, lo_w, out_w};
  const Strides sx{sxn, sxh, sxw, sxc};
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec * 2 + (x_f32 ? 1 : 0)) {
    case 16: act_pad_launch<8, bf16>(x, sx, r, b, s, out, N, H, W, C, ah, aw, act, st); break;
    case 2: act_pad_launch<1, bf16>(x, sx, r, b, s, out, N, H, W, C, ah, aw, act, st); break;
    case 3: act_pad_launch<1, float>(x, sx, r, b, s, out, N, H, W, C, ah, aw, act, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dx has x's type; both are addressed by their own strides (x is read only where act).
int sda_act_pad_bwd(const void* dq, const void* ds, const void* x, int x_f32, long long sxn,
                    long long sxh, long long sxw, long long sxc, const void* b, void* dx,
                    long long sdn, long long sdh, long long sdw, long long sdc, int N, int H,
                    int W, int C, int lo_h, int out_h, int lo_w, int out_w, int vec, int act,
                    void* stream) {
  if (C % vec != 0 || (vec > 1 && (sdc != 1 || (act && sxc != 1)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Axis ah{H, 1, lo_h, out_h}, aw{W, 1, lo_w, out_w};
  const Strides sx{sxn, sxh, sxw, sxc}, sd{sdn, sdh, sdw, sdc};
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec * 2 + (x_f32 ? 1 : 0)) {
    case 16: act_pad_bwd_launch<8, bf16>(dq, ds, x, sx, b, dx, sd, N, H, W, C, ah, aw, act, st); break;
    case 2: act_pad_bwd_launch<1, bf16>(dq, ds, x, sx, b, dx, sd, N, H, W, C, ah, aw, act, st); break;
    case 3: act_pad_bwd_launch<1, float>(dq, ds, x, sx, b, dx, sd, N, H, W, C, ah, aw, act, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
