// Truncated real 2-D DFT pair for Hopper (sm_90a), f32 in, f32 out.
//
// Replaces the Pallas TPU kernels of sda_tpu/ops/pallas_dft.py:
//   rfft2_kernel  <- _rfft2_raw  (:78) -> _rfft2_kernel  (:60)
//   irfft2_kernel <- _irfft2_raw (:127) -> _irfft2_kernel (:111)
// The Pallas kernels contract with dense DFT bases and keep the stage-1
// intermediate in VMEM. Here each 1-D pass is a factorised (Cooley-Tukey)
// transform in shared memory, and the intermediate stays on chip in the
// distributed shared memory of a thread-block cluster.
//
// Forward, x (N, H, W) -> re, im (N, Kh, Fw): the rows rows_h[a] (frequency
// mod H) and columns 0..Fw-1 of the 2-D DFT of each field. One cluster of C
// blocks per field, grid (C, N).
//   stage 1, along W: block b loads its band of ceil(H / C) rows once (one
//     cp.async.bulk per chunk of rows where the chunk is 16-byte aligned and
//     sized, coalesced loads otherwise), packs two real rows into one complex
//     sequence, transforms it, and unpacks the two half spectra into its
//     (rows, Fw) slice in shared memory, stored column by column.
//   cluster.sync(); stage 2, along H: block b owns a band of ceil(Fw / C)
//     columns, gathers them from every block's slice (map_shared_rank),
//     transforms them, and writes the kept rows of its columns once.
// Inverse, re, im (N, Kh, Fw) + Hermitian weights dw (Fw) -> x (N, H, W),
// the mirror: block b reads its band of spectrum columns once, scatters them
// to their rows (zeros elsewhere) and inverts along H into an (H, columns)
// slice; after cluster.sync() it gathers a band of rows, builds for each two
// rows the Hermitian-completed, dw-weighted sequence of the one and i times
// that of the other, inverts along W (the real and imaginary parts are the
// two rows) and writes its rows of x, coalesced, scaled by 1 / (H W).
// A last cluster.sync() keeps each block's slice alive while others read it.
// Inverses are conj(DFT(conj(.))), so one forward transform serves both.
//
// The 1-D transform: a Stockham autosort FFT over the radices of the axis's
// plan (16s, then a 4, then a 2, then odd primes; a prime factor runs as one
// direct small DFT): radix 16 as a 4 x 4 DFT in registers, 4 and 2 as
// butterflies, any other radix as a product with its DFT matrix. Several
// transforms run side by side, one butterfly per thread per step, in work
// buffers padded against bank conflicts. Plans, twiddles and matrices are
// built once per RealDFT2 in Python (float64, stored as f32) and copied into
// each block's shared memory.
//
// What bounds it: the function moves 0.38 MB per 256^2 field with 86 modes
// (field and truncated spectrum, f32), 0.113 us at 3.35 TB/s, and needs
// about 2.6 MFLOP as an FFT, 0.04 us at the f32 peak, so bytes set its bound.
// The contractions of the Pallas design do 52.6 MFLOP per field; this design
// does 1.9 MFLOP, so even at 64 fields its operations cost less than its
// bytes. Tensor cores are therefore not this function's limit: they would
// speed up operations that are not the bound (3xTF32 wgmma on the small DFT
// products stays queued, to take only if FMAs set the pace). Each input
// byte is read from device memory once and each output byte written once;
// the intermediate never leaves the cluster. At one field the work spreads
// over 16 SMs instead of re-reading the field on 86-128, and the time goes
// to the latency of the passes in series (loads, barriers, shared-memory
// round trips), which the design shortens with 512 threads, loads batched
// ahead of stores, multiply-high divisions and the bulk copy overlapping
// the tables' load. f32 FMAs throughout, no TF32: the solver was validated
// at the f32 accuracy of Precision.HIGHEST.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBuffer = 4096;  // complex values per work buffer (32 KB before padding)
constexpr int kPlanInts = 64;     // ints of one axis's plan (dft_kernels.PLAN_INTS)

// -- Complex arithmetic on float2 (x real, y imaginary) ----------------------

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// -- mbarrier and bulk copy (PTX) --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbarrier_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the phase of `parity` completes; a copy that never lands
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// One asynchronous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory, completing
// on `bar`. The fence orders earlier generic writes to the destination
// before the copy (async proxy) overwrites it.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// -- Tables -------------------------------------------------------------------

// Copies the plans, kept rows and tables into shared memory, where every
// step of the transforms reads them (from device memory each read would put
// an L2 round trip on the critical path of every stage).
// ints: [plan_h (kPlanInts), plan_w (kPlanInts), rows_h (Kh)].
__device__ __forceinline__ void load_tables(const int* __restrict__ ints_g,
                                            const float2* __restrict__ table_g, int* ints,
                                            float2* table, int Kh, int entries) {
  for (int i = threadIdx.x; i < 2 * kPlanInts + Kh; i += blockDim.x) ints[i] = ints_g[i];
  for (int i = threadIdx.x; i < entries; i += blockDim.x) table[i] = table_g[i];
}

// Runs store(i, load(i)) for i = 0..total-1 over the block, kBatch loads
// in flight per thread before their stores: the loads come from other
// blocks' shared memory or from device memory, and a store to shared memory
// between them would serialise their latencies.
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) store(i, v[u]);
    }
  }
}

// Division by a divisor fixed for a loop, as a multiply-high: exact for
// numerator and divisor below 2^16, which every index here is (a work
// buffer holds at most kMaxBuffer values). Runtime integer division would
// cost ~20 instructions in every step of the loops below.
struct Div {
  uint32_t d, magic;
  __device__ __forceinline__ explicit Div(int divisor)
      : d((uint32_t)divisor), magic(divisor > 1 ? 0xFFFFFFFFu / (uint32_t)divisor + 1u : 0u) {}
};
__device__ __forceinline__ int operator/(int n, Div v) {
  return v.d == 1 ? n : (int)__umulhi((uint32_t)n, v.magic);
}

// Work buffers are padded by one value in 16: value i sits at pad(i), so
// that the Stockham steps' strided stores (stride 16 values at the first
// radix-16 step) fall in distinct shared-memory banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// -- The 1-D transform --------------------------------------------------------

// In-place 4-point forward DFT.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 a0 = cadd(a, c), a1 = csub(a, c), a2 = cadd(b, d), a3 = csub(b, d);
  a = cadd(a0, a2);
  c = csub(a0, a2);
  b = make_float2(a1.x + a3.y, a1.y - a3.x);  // a1 - i a3
  d = make_float2(a1.x - a3.y, a1.y + a3.x);  // a1 + i a3
}

// e^{-2 pi i k / 16} for the k = q2 p1 <= 9 of dft16 (constants once unrolled).
__device__ __forceinline__ float2 w16(int k) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f, c2 = 0.70710678118654752f;
  switch (k) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(c2, -c2);
    case 3: return make_float2(s1, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 6: return make_float2(-c2, -c2);
    default: return make_float2(-c1, s1);  // 9
  }
}

// In-register 16-point forward DFT as 4 x 4: with q = 4 q1 + q2 and
// p = p1 + 4 p2, X_p = sum_q2 W4^{p2 q2} W16^{p1 q2} sum_q1 W4^{p1 q1} v_q.
// Leaves X_p in v[4 (p % 4) + p / 4].
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
  for (int q2 = 0; q2 < 4; ++q2) dft4(v[q2], v[4 + q2], v[8 + q2], v[12 + q2]);
#pragma unroll
  for (int p1 = 1; p1 < 4; ++p1) {
#pragma unroll
    for (int q2 = 1; q2 < 4; ++q2) v[4 * p1 + q2] = cmul(v[4 * p1 + q2], w16(p1 * q2));
  }
#pragma unroll
  for (int p1 = 0; p1 < 4; ++p1) dft4(v[4 * p1], v[4 * p1 + 1], v[4 * p1 + 2], v[4 * p1 + 3]);
}

// One Stockham step of radix r over `count` sequences of length n in padded
// buffers (see fft). a and b never overlap, so the loads of later
// butterflies may be issued before the stores of earlier ones.
template <int kRadix>
__device__ __forceinline__ void radix_step(const float2* __restrict__ a, float2* __restrict__ b,
                                           int count, int n, int ns,
                                           const float2* __restrict__ tw) {
  const int m = n / kRadix;
  const Div dm(m), dns(ns);
#pragma unroll(kRadix == 16 ? 1 : 2)
  for (int i = threadIdx.x; i < count * m; i += blockDim.x) {
    const int t = i / dm;
    const int j = i - t * m;
    const int k = j - (j / dns) * ns;
    const int src = t * n + j;
    const int dst = t * n + (j - k) * kRadix + k;
    float2 v[kRadix];
#pragma unroll
    for (int q = 0; q < kRadix; ++q) {
      const float2 x = a[pad(src + q * m)];
      v[q] = q ? cmul(x, tw[q * ns + k]) : x;
    }
    if constexpr (kRadix == 16) {
      dft16(v);
#pragma unroll
      for (int p = 0; p < kRadix; ++p) b[pad(dst + p * ns)] = v[4 * (p & 3) + (p >> 2)];
    } else {
      if constexpr (kRadix == 4) dft4(v[0], v[1], v[2], v[3]);
      if constexpr (kRadix == 2) {
        const float2 v0 = v[0];
        v[0] = cadd(v0, v[1]);
        v[1] = csub(v0, v[1]);
      }
#pragma unroll
      for (int p = 0; p < kRadix; ++p) b[pad(dst + p * ns)] = v[p];
    }
  }
}

// Any other radix: the product with its DFT matrix `mat`.
__device__ __forceinline__ void radix_any(const float2* __restrict__ a, float2* __restrict__ b,
                                          int count, int n, int ns, int r,
                                          const float2* __restrict__ tw,
                                          const float2* __restrict__ mat) {
  const int m = n / r;
  const Div dm(m), dns(ns);
  for (int i = threadIdx.x; i < count * m; i += blockDim.x) {
    const int t = i / dm;
    const int j = i - t * m;
    const int k = j - (j / dns) * ns;
    const int src = t * n + j;
    const int dst = t * n + (j - k) * r + k;
    for (int p = 0; p < r; ++p) {
      float2 acc = make_float2(0.f, 0.f);
      for (int q = 0; q < r; ++q) {
        const float2 v = cmul(a[pad(src + q * m)], tw[q * ns + k]);
        const float2 e = mat[p * r + q];
        acc.x = fmaf(e.x, v.x, fmaf(-e.y, v.y, acc.x));
        acc.y = fmaf(e.x, v.y, fmaf(e.y, v.x, acc.y));
      }
      b[pad(dst + p * ns)] = acc;
    }
  }
}

// Forward DFTs of `count` sequences of length plan[0], stored one after
// another in the padded buffer `a`; `b` is scratch of the same size. Plan
// (int32): [n, stages, radix[stages], twiddle offset[stages], matrix
// offset[stages]], offsets in complex entries of `table`, both in shared
// memory. Stage s (radix r, ns = product of the earlier radices) takes
// butterfly j = 0..n/r-1 of each sequence:
//   v_q = a[j + q n/r] * tw[q ns + k],  k = j mod ns,  tw = e^{-2 pi i k q / (ns r)}
//   b[(j - k) r + k + p ns] = sum_q e^{-2 pi i p q / r} v_q
// Ends with the result in natural order; returns the buffer that holds it.
// Every thread of the block must call it (it synchronises after each stage);
// the caller synchronises before it.
__device__ float2* fft(float2* a, float2* b, int count, const int* plan, const float2* table) {
  const int n = plan[0];
  const int stages = plan[1];
  int ns = 1;
  for (int s = 0; s < stages; ++s) {
    const int r = plan[2 + s];
    const float2* tw = table + plan[2 + stages + s];
    switch (r) {
      case 16: radix_step<16>(a, b, count, n, ns, tw); break;
      case 4: radix_step<4>(a, b, count, n, ns, tw); break;
      case 2: radix_step<2>(a, b, count, n, ns, tw); break;
      default: radix_any(a, b, count, n, ns, r, tw, table + plan[2 + 2 * stages + s]);
    }
    __syncthreads();
    float2* c = a;
    a = b;
    b = c;
    ns *= r;
  }
  return a;
}

// -- Forward ------------------------------------------------------------------

// Shared memory: two padded work buffers of `buffer` complex values, the
// slice, the table, one mbarrier, the ints. The slice keeps stage 1's
// (rows, Fw) output column by column, columns an odd `sb` values apart, so
// that the unpacking stores (consecutive columns) miss each other's banks
// and a peer gathers one column's rows as one contiguous run.
__global__ void __launch_bounds__(kThreads)
rfft2_kernel(const float* __restrict__ x, const int* __restrict__ ints_g,
             const float2* __restrict__ table_g, float* __restrict__ re, float* __restrict__ im,
             int H, int W, int Kh, int Fw, int entries, int buffer) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;

  extern __shared__ __align__(16) unsigned char smem[];
  const int padded = (pad(buffer) + 3) & ~1;
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + padded;
  float2* slice = buf1 + padded;
  const int band = (H + C - 1) / C;
  const int sb = band | 1;
  float2* table = slice + sb * Fw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(table + entries);
  int* ints = reinterpret_cast<int*>(bar + 1);
  const int* plan_h = ints;
  const int* plan_w = ints + kPlanInts;
  const int* rows_h = ints + 2 * kPlanInts;

  // Stage 1: this block's rows, two per complex transform along W. The
  // first chunk's copy is issued before the tables load, and overlaps it.
  const int r0 = rank * band;
  const int rows = max(0, min(band, H - r0));
  const int pairs = (rows + 1) / 2;
  const int chunk = buffer / W;  // row pairs per pass; the rows fit in buf1
  const float* xn = x + (size_t)n * H * W;
  float* staged = reinterpret_cast<float*>(buf1);
  const uint32_t bar_addr = smem_addr(bar);
  auto load_rows = [&](int p0) {  // true: a bulk copy is in flight on bar
    const int nrows = min(2 * min(chunk, pairs - p0), rows - 2 * p0);
    const float* src = xn + (size_t)(r0 + 2 * p0) * W;
    const uint32_t bytes = (uint32_t)(nrows * W) * 4u;
    if (((uintptr_t)src & 15) == 0 && (bytes & 15) == 0) {
      if (threadIdx.x == 0) {
        mbarrier_expect_tx(bar_addr, bytes);
        bulk_copy(smem_addr(staged), src, bytes, bar_addr);
      }
      return true;
    }
    for (int i = threadIdx.x; i < nrows * W; i += blockDim.x) staged[i] = src[i];
    return false;
  };
  if (threadIdx.x == 0) mbarrier_init(bar_addr, 1);
  __syncthreads();
  bool copying = pairs > 0 && load_rows(0);
  load_tables(ints_g, table_g, ints, table, Kh, entries);
  __syncthreads();

  const Div dW(W), dFw(Fw);
  uint32_t parity = 0;
  for (int p0 = 0; p0 < pairs; p0 += chunk) {
    const int np = min(chunk, pairs - p0);
    const int nrows = min(2 * np, rows - 2 * p0);
    if (p0 > 0) {
      copying = load_rows(p0);
      if (!copying) __syncthreads();
    }
    if (copying) {
      mbarrier_wait(bar_addr, parity);
      parity ^= 1;
    }
    batched<4>(
        np * W,
        [&](int i) {
          const int t = i / dW;
          const int w = i - t * W;
          const float odd = 2 * t + 1 < nrows ? staged[(2 * t + 1) * W + w] : 0.f;
          return make_float2(staged[2 * t * W + w], odd);
        },
        [&](int i, float2 v) { buf0[pad(i)] = v; });
    __syncthreads();
    const float2* z = fft(buf0, buf1, np, plan_w, table);
    // Z = A + i B with A, B the spectra of two real rows:
    // A_k = (Z_k + conj Z_-k) / 2, B_k = -i (Z_k - conj Z_-k) / 2.
    batched<4>(
        nrows * Fw,
        [&](int i) {
          const int row = i / dFw;
          const int f = i - row * Fw;
          const float2 zk = z[pad((row >> 1) * W + f)];
          const float2 zm = z[pad((row >> 1) * W + (f ? W - f : 0))];
          return row & 1 ? make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x))
                         : make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
        },
        [&](int i, float2 v) {
          const int row = i / dFw;
          slice[(i - row * Fw) * sb + 2 * p0 + row] = v;
        });
    __syncthreads();
  }

  cluster.sync();

  // Stage 2: this block's columns, gathered from every slice, along H.
  const int cband = (Fw + C - 1) / C;
  const int c0 = rank * cband;
  const int cols = max(0, min(cband, Fw - c0));
  const int cchunk = buffer / H;
  const Div dH(H), dband(band);
  float* ren = re + (size_t)n * Kh * Fw;
  float* imn = im + (size_t)n * Kh * Fw;
  for (int q0 = 0; q0 < cols; q0 += cchunk) {
    const int nq = min(cchunk, cols - q0);
    const Div dnq(nq);
    batched<4>(
        nq * H,
        [&](int i) {
          const int t = i / dH;
          const int h = i - t * H;
          const int owner = h / dband;
          const float2* peer = cluster.map_shared_rank(slice, owner);
          return peer[(c0 + q0 + t) * sb + h - owner * band];
        },
        [&](int i, float2 v) { buf0[pad(i)] = v; });
    __syncthreads();
    const float2* y = fft(buf0, buf1, nq, plan_h, table);
    for (int i = threadIdx.x; i < Kh * nq; i += blockDim.x) {
      const int a = i / dnq;
      const int t = i - a * nq;
      const float2 v = y[pad(t * H + rows_h[a])];
      ren[(size_t)a * Fw + c0 + q0 + t] = v.x;
      imn[(size_t)a * Fw + c0 + q0 + t] = v.y;
    }
    __syncthreads();
  }

  cluster.sync();  // no block leaves while another may read its slice
}

// -- Inverse ------------------------------------------------------------------

// Shared memory: two padded work buffers of `buffer` complex values, the
// (H, columns) slice with an odd row stride `sc`, the table, dw, the ints.
__global__ void __launch_bounds__(kThreads)
irfft2_kernel(const float* __restrict__ re, const float* __restrict__ im,
              const int* __restrict__ ints_g, const float2* __restrict__ table_g,
              const float* __restrict__ dw_g, float* __restrict__ x, int H, int W, int Kh, int Fw,
              int entries, float scale, int buffer) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;

  extern __shared__ __align__(16) unsigned char smem[];
  const int padded = (pad(buffer) + 3) & ~1;
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + padded;
  float2* slice = buf1 + padded;
  const int cband = (Fw + C - 1) / C;
  const int sc = cband | 1;
  float2* table = slice + H * sc;
  float* dw = reinterpret_cast<float*>(table + entries);
  int* ints = reinterpret_cast<int*>(dw + Fw);
  const int* plan_h = ints;
  const int* plan_w = ints + kPlanInts;
  const int* rows_h = ints + 2 * kPlanInts;
  load_tables(ints_g, table_g, ints, table, Kh, entries);
  for (int i = threadIdx.x; i < Fw; i += blockDim.x) dw[i] = dw_g[i];
  __syncthreads();

  // Stage 1: this block's columns, scattered to their rows, along H.
  const int c0 = rank * cband;
  const int cols = max(0, min(cband, Fw - c0));
  const int cchunk = buffer / H;
  const Div dH(H);
  const float* ren = re + (size_t)n * Kh * Fw;
  const float* imn = im + (size_t)n * Kh * Fw;
  for (int q0 = 0; q0 < cols; q0 += cchunk) {
    const int nq = min(cchunk, cols - q0);
    const Div dnq(nq);
    for (int i = threadIdx.x; i < pad(nq * H); i += blockDim.x) buf0[i] = make_float2(0.f, 0.f);
    __syncthreads();
    batched<4>(
        Kh * nq,
        [&](int i) {
          const int a = i / dnq;
          const size_t at = (size_t)a * Fw + c0 + q0 + i - a * nq;
          return make_float2(ren[at], -imn[at]);
        },
        [&](int i, float2 v) {
          const int a = i / dnq;
          buf0[pad((i - a * nq) * H + rows_h[a])] = v;
        });
    __syncthreads();
    const float2* y = fft(buf0, buf1, nq, plan_h, table);
    batched<4>(
        nq * H,
        [&](int i) {
          const float2 v = y[pad(i)];
          return make_float2(v.x, -v.y);
        },
        [&](int i, float2 v) {
          const int t = i / dH;
          const int h = i - t * H;
          slice[h * sc + q0 + t] = v;
        });
    __syncthreads();
  }

  cluster.sync();

  // Stage 2: this block's rows, two per complex transform along W.
  const int band = (H + C - 1) / C;
  const int r0 = rank * band;
  const int rows = max(0, min(band, H - r0));
  const int pairs = (rows + 1) / 2;
  const int chunk = buffer / W;
  const Div dW(W), dcband(cband);
  float* xn = x + (size_t)n * H * W;
  for (int p0 = 0; p0 < pairs; p0 += chunk) {
    const int np = min(chunk, pairs - p0);
    const int nrows = min(2 * np, rows - 2 * p0);
    // Z_k = sum over f in {k, -k} of dw_f / 2 (Y_a + i Y_b), conjugated at -k.
    auto build = [&](int i) {
      const int t = i / dW;
      const int k = i - t * W;
      const int ha = r0 + 2 * (p0 + t);
      const bool second = 2 * t + 1 < nrows;
      float2 z = make_float2(0.f, 0.f);
      if (k < Fw) {
        const int owner = k / dcband;
        const float2* peer = cluster.map_shared_rank(slice, owner) + k - owner * cband;
        const float2 ya = peer[ha * sc];
        const float2 yb = second ? peer[(ha + 1) * sc] : make_float2(0.f, 0.f);
        const float d = 0.5f * dw[k];
        z.x += d * (ya.x - yb.y);
        z.y += d * (ya.y + yb.x);
      }
      const int m = k ? W - k : 0;
      if (m < Fw) {
        const int owner = m / dcband;
        const float2* peer = cluster.map_shared_rank(slice, owner) + m - owner * cband;
        const float2 ya = peer[ha * sc];
        const float2 yb = second ? peer[(ha + 1) * sc] : make_float2(0.f, 0.f);
        const float d = 0.5f * dw[m];
        z.x += d * (ya.x + yb.y);
        z.y += d * (yb.x - ya.y);
      }
      return make_float2(z.x, -z.y);
    };
    batched<4>(np * W, build, [&](int i, float2 v) { buf0[pad(i)] = v; });
    __syncthreads();
    const float2* y = fft(buf0, buf1, np, plan_w, table);
    for (int i = threadIdx.x; i < np * W; i += blockDim.x) {
      const int t = i / dW;
      const int w = i - t * W;
      const int ha = r0 + 2 * (p0 + t);
      const float2 v = y[pad(i)];  // conj of x_a + i x_b
      xn[(size_t)ha * W + w] = v.x * scale;
      if (2 * t + 1 < nrows) xn[(size_t)(ha + 1) * W + w] = -v.y * scale;
    }
    __syncthreads();
  }

  cluster.sync();  // no block leaves while another may read its slice
}

// -- Launch -------------------------------------------------------------------

// Work buffers hold one pass of either stage: a band's row pairs along W or
// a band's columns along H, at most kMaxBuffer values (longer bands run in
// chunks) and at least one transform of each axis.
int work_buffer(int H, int W, int Fw, int C) {
  const int band = (H + C - 1) / C;
  const int cband = (Fw + C - 1) / C;
  const int buffer = max((band + 1) / 2 * W, cband * H);
  return max(min(buffer, kMaxBuffer), max(H, W));
}

// Two padded buffers (at least pad(buffer) + 1 values each, an even count,
// so both start 16-byte aligned), the slice with its odd stride, the table,
// then the forward's mbarrier or the inverse's dw, and the ints.
size_t buffers_smem(int buffer) { return 16 * (size_t)((buffer + (buffer >> 4) + 3) & ~1); }

size_t rfft2_smem(int H, int Kh, int Fw, int C, int entries, int buffer) {
  return buffers_smem(buffer) + 8 * (size_t)(((H + C - 1) / C) | 1) * Fw + 8 * (size_t)entries +
         8 + 4 * (size_t)(2 * kPlanInts + Kh);
}

size_t irfft2_smem(int H, int Kh, int Fw, int C, int entries, int buffer) {
  return buffers_smem(buffer) + 8 * (size_t)H * (((Fw + C - 1) / C) | 1) + 8 * (size_t)entries +
         4 * (size_t)Fw + 4 * (size_t)(2 * kPlanInts + Kh);
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Launch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute cluster;

  Launch(int C, int N, size_t smem, cudaStream_t stream) : config(), cluster() {
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = C;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.gridDim = dim3(C, N);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = &cluster;
    config.numAttrs = 1;
  }
};

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` without synchronising and
// returns cudaGetLastError() as an int (0 = launched). `cluster` is the
// number of blocks per field (2, 4, 8 or 16); any other value is refused.
// `ints` and `table` (`entries` complex values) are RealDFT2's Plan.

int sda_rfft2(const float* x, const int* ints, const float* table, float* re, float* im, int N,
              int H, int W, int Kh, int Fw, int entries, int cluster, void* stream) {
  switch (cluster) {
    case 2: case 4: case 8: case 16: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int buffer = work_buffer(H, W, Fw, cluster);
  const size_t smem = rfft2_smem(H, Kh, Fw, cluster, entries, buffer);
  cudaError_t err = configure(rfft2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  Launch launch(cluster, N, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&launch.config, rfft2_kernel, x, ints, (const float2*)table, re, im, H,
                           W, Kh, Fw, entries, buffer);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int sda_irfft2(const float* re, const float* im, const int* ints, const float* table,
               const float* dw, float* x, int N, int H, int W, int Kh, int Fw, int entries,
               float scale, int cluster, void* stream) {
  switch (cluster) {
    case 2: case 4: case 8: case 16: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int buffer = work_buffer(H, W, Fw, cluster);
  const size_t smem = irfft2_smem(H, Kh, Fw, cluster, entries, buffer);
  cudaError_t err = configure(irfft2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  Launch launch(cluster, N, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&launch.config, irfft2_kernel, re, im, ints, (const float2*)table, dw,
                           x, H, W, Kh, Fw, entries, scale, buffer);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of the forward (inverse != 0: the
// inverse) kernel can be resident at once for this shape, into *count, and
// the dynamic shared memory per block into *smem_bytes; returns the CUDA
// error as an int.
int sda_dft_max_clusters(int inverse, int H, int W, int Kh, int Fw, int entries, int cluster,
                         int* count, int* smem_bytes) {
  const int buffer = work_buffer(H, W, Fw, cluster);
  const size_t smem = inverse ? irfft2_smem(H, Kh, Fw, cluster, entries, buffer)
                              : rfft2_smem(H, Kh, Fw, cluster, entries, buffer);
  *smem_bytes = (int)smem;
  cudaError_t err = inverse ? configure(irfft2_kernel, smem) : configure(rfft2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  Launch launch(cluster, 1, smem, 0);
  err = inverse ? cudaOccupancyMaxActiveClusters(count, irfft2_kernel, &launch.config)
                : cudaOccupancyMaxActiveClusters(count, rfft2_kernel, &launch.config);
  return (int)err;
}

}  // extern "C"
