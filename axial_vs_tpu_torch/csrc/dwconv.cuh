// What K1 (dwconv_ln.cu) and the P1 probe (dwconv_variants.cu) share: the
// vector loads and stores, the strip LayerNorm sum, and how a launch picks
// the strips a block holds and the pixels it walks.
//
// Both kernels give a thread V channels of a few output pixels, put G such
// column strips of C / V threads side by side in a block, and walk the block
// along the image; the LayerNorm sums of a pixel run over its strip.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // the SM count

namespace axvs_dwconv {

constexpr int MIN_THREADS = 96;  // strips in a block until it has this many threads
constexpr int MAX_WALK = 16;     // output rows (or columns) a block walks

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive elements of type T as f32, one vector load (V * sizeof(T) =
// 4, 8 or 16 bytes, aligned).
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<__nv_bfloat16, V> {
  static_assert(V == 2 || V == 4 || V == 8, "bf16 vectors of 2, 4 or 8");
  typedef typename std::conditional<V == 8, uint4, typename std::conditional<
      V == 4, uint2, uint32_t>::type>::type Raw;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[V]) {
    const Raw raw = *reinterpret_cast<const Raw*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[V]) {
    Raw raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<Raw*>(p) = raw;
  }
};

template <int V>
struct Vec<float, V> {
  static_assert(V == 2 || V == 4, "f32 vectors of 2 or 4");
  typedef typename std::conditional<V == 4, float4, float2>::type Raw;
  __device__ __forceinline__ static void load(const float* p, float (&v)[V]) {
    const Raw raw = *reinterpret_cast<const Raw*>(p);
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = f[i];
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[V]) {
    Raw raw;
    float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = v[i];
    *reinterpret_cast<Raw*>(p) = raw;
  }
};

// Replaces s[p] by its sum over the CG threads of this thread's strip, for
// each of the TW pixels (live: the thread is in one of the G strips; the
// block is whole warps). part: G * CG * TW floats; tot: G * TW floats. Each
// (strip, pixel) row has one warp, whose 32 lanes sum its partials in a fixed
// order: the result does not vary by run.
template <int TW>
__device__ __forceinline__ void strip_sum(float (&s)[TW], float* part, float* tot, int CG,
                                          int G, int g, int t, bool live) {
  const int rows = G * TW;  // (strip, pixel) pairs of the block
  if (live) {
#pragma unroll
    for (int p = 0; p < TW; ++p) part[(g * TW + p) * CG + t] = s[p];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    float v = 0.f;
    for (int i = lane; i < CG; i += 32) v += part[r * CG + i];
    v = warp_sum(v);
    if (lane == 0) tot[r] = v;
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int p = 0; p < TW; ++p) s[p] = tot[g * TW + p];
  }
  // the next call writes part only after its own first barrier has been
  // passed by every thread, which happens after all have read tot here
}

// Strips of CG threads a block holds: as many as bring it to MIN_THREADS
// threads, within max_threads.
inline int strips_per_block(int CG, int max_threads) {
  int G = 1;
  while (CG * G < MIN_THREADS && CG * (G + 1) <= max_threads) ++G;
  return G;
}

// Output rows (or columns) a block walks when `strips` strips each cover
// `len` of them: as many as keep about 8 blocks on each SM, 1 to MAX_WALK.
inline cudaError_t walk_length(long long strips, int len, int* walk) {
  int sms = 0;
  const cudaError_t err = axvs_hopper::sm_count(&sms);
  if (err != cudaSuccess) return err;
  long long n = strips * len / (8LL * sms);
  n = n < 1 ? 1 : (n > MAX_WALK ? MAX_WALK : n);
  *walk = (int)n;
  return cudaSuccess;
}

}  // namespace axvs_dwconv
