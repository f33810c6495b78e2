// The lanes that run one sample of a rollout kernel, for
// spatial_dynamics.cuh (a warp a sample, W = 32) and planar_dynamics.cuh (a
// group of W = 4, 8, 16 or 32 lanes a sample): the group's lane index, a
// ballot of the group shifted to its lane 0, a shuffle within the group, a
// barrier of the group and, for a warp, sums over the lanes in lane order. In the host
// builds (tests/*_host_check.cpp) a sample has one lane (W = 1), where every
// primitive is the identity.
//
// A group of W < 32 lanes is an aligned W-wide slice of a warp; its
// primitives name only its own lanes (the mask of the slice), so the groups
// of one warp may branch apart (each runs its own sample) without waiting
// for each other.
#pragma once

namespace mpopis {

template <int W>
struct Lanes;

template <>
struct Lanes<1> {
  __device__ __forceinline__ static int lane() { return 0; }
  __device__ __forceinline__ static unsigned below() { return 0u; }  // the lanes under this one
  __device__ __forceinline__ static unsigned ballot(bool p) { return p ? 1u : 0u; }
  template <typename T>
  __device__ __forceinline__ static T sum(T v, int) { return v; }
  template <typename T>
  __device__ __forceinline__ static void sum2(T&, T&, int) {}
  __device__ __forceinline__ static void sync() {}
};

#ifdef __CUDACC__
template <>
struct Lanes<32> {
  __device__ __forceinline__ static int lane() { return threadIdx.x & 31; }
  __device__ __forceinline__ static unsigned below() { return (1u << lane()) - 1u; }
  __device__ __forceinline__ static unsigned ballot(bool p) { return __ballot_sync(0xffffffffu, p); }
  // the sum of v over lanes 0 .. n - 1 in lane order, on every lane (n the
  // same on every lane, the lanes past it holding 0): with a row on each
  // lane, the rows' sum in the plain version's serial order
  template <typename T>
  __device__ __forceinline__ static T sum(T v, int n) {
    T s = T(0);
    for (int l = 0; l < n; ++l) s = s + __shfl_sync(0xffffffffu, v, l);
    return s;
  }
  // two sums at once, their shuffles interleaved
  template <typename T>
  __device__ __forceinline__ static void sum2(T& a, T& b, int n) {
    T sa = T(0), sb = T(0);
    for (int l = 0; l < n; ++l) {
      const T xa = __shfl_sync(0xffffffffu, a, l);
      const T xb = __shfl_sync(0xffffffffu, b, l);
      sa = sa + xa;
      sb = sb + xb;
    }
    a = sa;
    b = sb;
  }
  __device__ __forceinline__ static void sync() { __syncwarp(); }
};

// W = 4, 8 or 16 lanes: the slice of the warp from lane base() on
template <int W>
struct Lanes {
  static_assert(W == 4 || W == 8 || W == 16, "a group is 1, 4, 8, 16 or 32 lanes");
  __device__ __forceinline__ static int lane() { return threadIdx.x & (W - 1); }
  __device__ __forceinline__ static int base() { return threadIdx.x & 31 & ~(W - 1); }
  __device__ __forceinline__ static unsigned mask() { return ((1u << W) - 1u) << base(); }
  __device__ __forceinline__ static unsigned below() { return (1u << lane()) - 1u; }
  __device__ __forceinline__ static unsigned ballot(bool p) {
    const unsigned m = mask();
    return (__ballot_sync(m, p) & m) >> base();
  }
  __device__ __forceinline__ static void sync() { __syncwarp(mask()); }
};

__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
#else
inline int popc(unsigned x) { return __builtin_popcount(x); }
#endif

// v of lane `src` of this sample's group, on every lane of the group
template <int W, typename T>
__device__ __forceinline__ T lane_value(T v, int src) {
  if constexpr (W == 1) {
    return v;
  } else {
#ifdef __CUDACC__
    if constexpr (W == 32) {
      return __shfl_sync(0xffffffffu, v, src);
    } else {
      return __shfl_sync(Lanes<W>::mask(), v, src, W);
    }
#else
    return v;
#endif
  }
}

}  // namespace mpopis
