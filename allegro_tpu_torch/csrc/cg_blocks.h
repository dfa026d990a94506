// Generated by allegro_tpu_torch/ops/gen_cg_blocks.py from lib/wigner.py: do not edit.
//
// CgBlock<l1, l2, l3> is one tensor-product path for one channel, with
// C = wigner_3j(l1, l2, l3) * sqrt(2 l3 + 1): its nonzero coefficients are
// literals, in straight-line FMAs. fwd is the path itself: with x and e the
// path's slices of the two inputs (one of them already times the path
// weight), it adds out[c] += sum_ab C[a,b,c] x[a] e[b]. bwd is its transpose
// in the two inputs: with g the output cotangent's slice (already times the
// path weight), it adds dx[a] += sum_bc C[a,b,c] e[b] g[c] and
// de[b] += sum_ac C[a,b,c] x[a] g[c]. cg_dispatch(tid, f) calls
// f.template run<l1, l2, l3>() for the triple of id tid
// (gen_cg_blocks.TRIPLES) and returns false for any other.

#pragma once

namespace {

constexpr int kCgTriples = 34;
constexpr int kCgCoefficients = 611;

template <int L1, int L2, int L3>
struct CgBlock;

// triple 0: (0, 0, 0), 1 coefficients
template <>
struct CgBlock<0, 0, 0> {
  static __device__ __forceinline__ void fwd(const float (&x)[1], const float (&e)[1], float (&out)[1]) {
    { const float t = static_cast<float>(1.0) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[1], const float (&e)[1], const float (&g)[1],
                                             float (&dx)[1], float (&de)[1]) {
    { const float t = static_cast<float>(1.0) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
  }
};

// triple 1: (0, 1, 1), 3 coefficients
template <>
struct CgBlock<0, 1, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[1], const float (&e)[3], float (&out)[3]) {
    { const float t = static_cast<float>(1.0000000000000007) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.9999999999999999) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.9999999999999997) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[1], const float (&e)[3], const float (&g)[3],
                                             float (&dx)[1], float (&de)[3]) {
    { const float t = static_cast<float>(1.0000000000000007) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.9999999999999999) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.9999999999999997) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
  }
};

// triple 2: (0, 2, 2), 5 coefficients
template <>
struct CgBlock<0, 2, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[1], const float (&e)[5], float (&out)[5]) {
    { const float t = static_cast<float>(0.9999999999999977) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(1.0000000000000007) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(1.0000000000000016) * x[0]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(1.0) * x[0]; out[4] = fmaf(t, e[4], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[1], const float (&e)[5], const float (&g)[5],
                                             float (&dx)[1], float (&de)[5]) {
    { const float t = static_cast<float>(0.9999999999999977) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(1.0000000000000007) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(1.0000000000000016) * g[3]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(1.0) * g[4]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
  }
};

// triple 3: (0, 3, 3), 7 coefficients
template <>
struct CgBlock<0, 3, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[1], const float (&e)[7], float (&out)[7]) {
    { const float t = static_cast<float>(0.9999999999999988) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(1.000000000000001) * x[0]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(0.9999999999999996) * x[0]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[0]; out[5] = fmaf(t, e[5], out[5]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[0]; out[6] = fmaf(t, e[6], out[6]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[1], const float (&e)[7], const float (&g)[7],
                                             float (&dx)[1], float (&de)[7]) {
    { const float t = static_cast<float>(0.9999999999999988) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(1.000000000000001) * g[3]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.9999999999999996) * g[4]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[5]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[6]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
  }
};

// triple 4: (1, 0, 1), 3 coefficients
template <>
struct CgBlock<1, 0, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[1], float (&out)[3]) {
    { const float t = static_cast<float>(1.0) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(1.0) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.9999999999999999) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[1], const float (&g)[3],
                                             float (&dx)[3], float (&de)[1]) {
    { const float t = static_cast<float>(1.0) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(1.0) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.9999999999999999) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
  }
};

// triple 5: (1, 1, 0), 3 coefficients
template <>
struct CgBlock<1, 1, 0> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[3], float (&out)[1]) {
    { const float t = static_cast<float>(0.5773502691896261) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.5773502691896256) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.5773502691896257) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[3], const float (&g)[1],
                                             float (&dx)[3], float (&de)[3]) {
    { const float t = static_cast<float>(0.5773502691896261) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.5773502691896256) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.5773502691896257) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
  }
};

// triple 6: (1, 1, 1), 6 coefficients
template <>
struct CgBlock<1, 1, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[3], float (&out)[3]) {
    { const float t = static_cast<float>(0.7071067811865475) * x[0]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.7071067811865479) * x[0]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.7071067811865478) * x[1]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.7071067811865472) * x[1]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.7071067811865477) * x[2]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.7071067811865476) * x[2]; out[0] = fmaf(t, e[1], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[3], const float (&g)[3],
                                             float (&dx)[3], float (&de)[3]) {
    { const float t = static_cast<float>(0.7071067811865475) * g[2]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865479) * g[1]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865478) * g[2]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.7071067811865472) * g[0]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.7071067811865477) * g[1]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.7071067811865476) * g[0]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
  }
};

// triple 7: (1, 1, 2), 11 coefficients
template <>
struct CgBlock<1, 1, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[3], float (&out)[5]) {
    { const float t = static_cast<float>(0.408248290463863) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.7071067811865485) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.7071067811865478) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.7071067811865468) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.7071067811865475) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.8164965809277253) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.7071067811865479) * x[1]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.7071067811865468) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.7071067811865482) * x[2]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.4082482904638637) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.7071067811865471) * x[2]; out[4] = fmaf(t, e[2], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[3], const float (&g)[5],
                                             float (&dx)[3], float (&de)[3]) {
    { const float t = static_cast<float>(0.408248290463863) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.7071067811865485) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.7071067811865478) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865468) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865475) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.8164965809277253) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865479) * g[3]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865468) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.7071067811865482) * g[3]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.4082482904638637) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865471) * g[4]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
  }
};

// triple 8: (1, 2, 1), 11 coefficients
template <>
struct CgBlock<1, 2, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[5], float (&out)[3]) {
    { const float t = static_cast<float>(0.5477225575051656) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.5477225575051666) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.3162277660168386) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.547722557505166) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.5477225575051664) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.6324555320336753) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.5477225575051665) * x[1]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.5477225575051656) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.3162277660168374) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.5477225575051667) * x[2]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.5477225575051656) * x[2]; out[2] = fmaf(t, e[4], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[5], const float (&g)[3],
                                             float (&dx)[3], float (&de)[5]) {
    { const float t = static_cast<float>(0.5477225575051656) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.5477225575051666) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.3162277660168386) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.547722557505166) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.5477225575051664) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.6324555320336753) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.5477225575051665) * g[2]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(0.5477225575051656) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.3162277660168374) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.5477225575051667) * g[1]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.5477225575051656) * g[2]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
  }
};

// triple 9: (1, 2, 2), 16 coefficients
template <>
struct CgBlock<1, 2, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[5], float (&out)[5]) {
    { const float t = static_cast<float>(0.4082482904638627) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.40824829046386274) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.7071067811865486) * x[0]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(0.7071067811865478) * x[0]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.40824829046386313) * x[0]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(0.40824829046386396) * x[0]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.8164965809277253) * x[1]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.40824829046386385) * x[1]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.4082482904638636) * x[1]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.816496580927725) * x[1]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.4082482904638629) * x[2]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.7071067811865477) * x[2]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.4082482904638636) * x[2]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.7071067811865474) * x[2]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.4082482904638622) * x[2]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.4082482904638634) * x[2]; out[1] = fmaf(t, e[4], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[5], const float (&g)[5],
                                             float (&dx)[3], float (&de)[5]) {
    { const float t = static_cast<float>(0.4082482904638627) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.40824829046386274) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865486) * g[3]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.7071067811865478) * g[2]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.40824829046386313) * g[4]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.40824829046386396) * g[3]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.8164965809277253) * g[4]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.40824829046386385) * g[3]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.4082482904638636) * g[1]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.816496580927725) * g[0]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.4082482904638629) * g[3]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.7071067811865477) * g[2]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.4082482904638636) * g[4]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.7071067811865474) * g[1]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.4082482904638622) * g[0]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.4082482904638634) * g[1]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
  }
};

// triple 10: (1, 2, 3), 21 coefficients
template <>
struct CgBlock<1, 2, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[5], float (&out)[7]) {
    { const float t = static_cast<float>(0.18257418583505505) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.7071067811865465) * x[0]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(0.4472135954999586) * x[0]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.5773502691896261) * x[0]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(-0.6324555320336764) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896263) * x[0]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.7071067811865477) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.18257418583505508) * x[0]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896237) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.7302967433402227) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.7745966692414843) * x[1]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.7302967433402224) * x[1]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.5773502691896258) * x[1]; out[5] = fmaf(t, e[4], out[5]); }
    { const float t = static_cast<float>(-0.7071067811865461) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.18257418583505514) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896261) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.6324555320336758) * x[2]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(0.4472135954999583) * x[2]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(-0.5773502691896261) * x[2]; out[5] = fmaf(t, e[3], out[5]); }
    { const float t = static_cast<float>(0.18257418583505564) * x[2]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.707106781186548) * x[2]; out[6] = fmaf(t, e[4], out[6]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[5], const float (&g)[7],
                                             float (&dx)[3], float (&de)[5]) {
    { const float t = static_cast<float>(0.18257418583505505) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.7071067811865465) * g[6]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.4472135954999586) * g[3]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.5773502691896261) * g[5]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.6324555320336764) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.5773502691896263) * g[1]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.7071067811865477) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.18257418583505508) * g[2]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.5773502691896237) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.7302967433402227) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.7745966692414843) * g[3]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.7302967433402224) * g[4]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.5773502691896258) * g[5]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.7071067811865461) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.18257418583505514) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.5773502691896261) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.6324555320336758) * g[4]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.4472135954999583) * g[3]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(-0.5773502691896261) * g[5]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.18257418583505564) * g[4]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.707106781186548) * g[6]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
  }
};

// triple 11: (1, 3, 2), 21 coefficients
template <>
struct CgBlock<1, 3, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[7], float (&out)[5]) {
    { const float t = static_cast<float>(0.5976143046671963) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.4879500364742667) * x[0]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.5345224838248489) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.15430334996209213) * x[0]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.37796447300922703) * x[0]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.15430334996209177) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.4879500364742674) * x[0]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.5976143046671962) * x[0]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(0.48795003647426605) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.6172133998483685) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.6546536707079776) * x[1]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.6172133998483683) * x[1]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.48795003647426616) * x[1]; out[4] = fmaf(t, e[5], out[4]); }
    { const float t = static_cast<float>(0.5976143046671964) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.4879500364742668) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.1543033499620918) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.3779644730092277) * x[2]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(0.5345224838248486) * x[2]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.1543033499620919) * x[2]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(0.4879500364742672) * x[2]; out[3] = fmaf(t, e[5], out[3]); }
    { const float t = static_cast<float>(0.5976143046671963) * x[2]; out[4] = fmaf(t, e[6], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[7], const float (&g)[5],
                                             float (&dx)[3], float (&de)[7]) {
    { const float t = static_cast<float>(0.5976143046671963) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.4879500364742667) * g[3]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.5345224838248489) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.15430334996209213) * g[4]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.37796447300922703) * g[1]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.15430334996209177) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.4879500364742674) * g[1]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(-0.5976143046671962) * g[0]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(0.48795003647426605) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.6172133998483685) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.6546536707079776) * g[2]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(0.6172133998483683) * g[3]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.48795003647426616) * g[4]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(0.5976143046671964) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.4879500364742668) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.1543033499620918) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.3779644730092277) * g[3]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.5345224838248486) * g[2]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.1543033499620919) * g[4]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.4879500364742672) * g[3]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.5976143046671963) * g[4]; dx[2] = fmaf(t, e[6], dx[2]); de[6] = fmaf(t, x[2], de[6]); }
  }
};

// triple 12: (1, 3, 3), 26 coefficients
template <>
struct CgBlock<1, 3, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[3], const float (&e)[7], float (&out)[7]) {
    { const float t = static_cast<float>(0.353553390593274) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.353553390593274) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.4564354645876386) * x[0]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.4564354645876391) * x[0]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.707106781186547) * x[0]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(0.707106781186547) * x[0]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.4564354645876386) * x[0]; out[5] = fmaf(t, e[4], out[5]); }
    { const float t = static_cast<float>(0.45643546458763906) * x[0]; out[4] = fmaf(t, e[5], out[4]); }
    { const float t = static_cast<float>(-0.3535533905932737) * x[0]; out[6] = fmaf(t, e[5], out[6]); }
    { const float t = static_cast<float>(0.35355339059327395) * x[0]; out[5] = fmaf(t, e[6], out[5]); }
    { const float t = static_cast<float>(0.8660254037844383) * x[1]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(0.5773502691896264) * x[1]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(0.28867513459481303) * x[1]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.28867513459481314) * x[1]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896261) * x[1]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.8660254037844387) * x[1]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(-0.35355339059327334) * x[2]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.4564354645876387) * x[2]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.35355339059327423) * x[2]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(-0.7071067811865477) * x[2]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.45643546458763773) * x[2]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(0.7071067811865476) * x[2]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.4564354645876386) * x[2]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.35355339059327384) * x[2]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.4564354645876387) * x[2]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.3535533905932738) * x[2]; out[1] = fmaf(t, e[6], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[3], const float (&e)[7], const float (&g)[7],
                                             float (&dx)[3], float (&de)[7]) {
    { const float t = static_cast<float>(0.353553390593274) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.353553390593274) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.4564354645876386) * g[2]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.4564354645876391) * g[1]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.707106781186547) * g[4]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.707106781186547) * g[3]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.4564354645876386) * g[5]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.45643546458763906) * g[4]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(-0.3535533905932737) * g[6]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(0.35355339059327395) * g[5]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(0.8660254037844383) * g[6]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.5773502691896264) * g[5]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.28867513459481303) * g[4]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.28867513459481314) * g[2]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.5773502691896261) * g[1]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(-0.8660254037844387) * g[0]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(-0.35355339059327334) * g[5]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.4564354645876387) * g[4]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.35355339059327423) * g[6]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865477) * g[3]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.45643546458763773) * g[5]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.7071067811865476) * g[2]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.4564354645876386) * g[1]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.35355339059327384) * g[0]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.4564354645876387) * g[2]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.3535533905932738) * g[1]; dx[2] = fmaf(t, e[6], dx[2]); de[6] = fmaf(t, x[2], de[6]); }
  }
};

// triple 13: (2, 0, 2), 5 coefficients
template <>
struct CgBlock<2, 0, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[1], float (&out)[5]) {
    { const float t = static_cast<float>(0.9999999999999978) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(1.0000000000000009) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(1.0000000000000004) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(1.0000000000000016) * x[3]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[4]; out[4] = fmaf(t, e[0], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[1], const float (&g)[5],
                                             float (&dx)[5], float (&de)[1]) {
    { const float t = static_cast<float>(0.9999999999999978) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(1.0000000000000009) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(1.0000000000000004) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(1.0000000000000016) * g[3]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[4]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
  }
};

// triple 14: (2, 1, 1), 11 coefficients
template <>
struct CgBlock<2, 1, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[3], float (&out)[3]) {
    { const float t = static_cast<float>(0.5477225575051654) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.5477225575051652) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.5477225575051665) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.5477225575051666) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.31622776601683733) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.6324555320336758) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.3162277660168381) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.5477225575051666) * x[3]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.5477225575051664) * x[3]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.5477225575051663) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.5477225575051659) * x[4]; out[2] = fmaf(t, e[2], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[3], const float (&g)[3],
                                             float (&dx)[5], float (&de)[3]) {
    { const float t = static_cast<float>(0.5477225575051654) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.5477225575051652) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.5477225575051665) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.5477225575051666) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.31622776601683733) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.6324555320336758) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.3162277660168381) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.5477225575051666) * g[2]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.5477225575051664) * g[1]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.5477225575051663) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.5477225575051659) * g[2]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
  }
};

// triple 15: (2, 1, 2), 16 coefficients
template <>
struct CgBlock<2, 1, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[3], float (&out)[5]) {
    { const float t = static_cast<float>(0.4082482904638628) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.8164965809277238) * x[0]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.4082482904638629) * x[0]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.40824829046386296) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.4082482904638634) * x[1]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.7071067811865482) * x[1]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.408248290463863) * x[1]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.7071067811865487) * x[2]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.7071067811865478) * x[2]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.707106781186549) * x[3]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.408248290463864) * x[3]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.408248290463864) * x[3]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.408248290463863) * x[3]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.4082482904638638) * x[4]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.8164965809277249) * x[4]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.4082482904638629) * x[4]; out[1] = fmaf(t, e[2], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[3], const float (&g)[5],
                                             float (&dx)[5], float (&de)[3]) {
    { const float t = static_cast<float>(0.4082482904638628) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.8164965809277238) * g[4]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.4082482904638629) * g[3]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.40824829046386296) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.4082482904638634) * g[3]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865482) * g[2]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.408248290463863) * g[4]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865487) * g[3]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.7071067811865478) * g[1]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.707106781186549) * g[2]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.408248290463864) * g[4]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.408248290463864) * g[1]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.408248290463863) * g[0]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(0.4082482904638638) * g[3]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.8164965809277249) * g[0]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.4082482904638629) * g[1]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
  }
};

// triple 16: (2, 1, 3), 21 coefficients
template <>
struct CgBlock<2, 1, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[3], float (&out)[7]) {
    { const float t = static_cast<float>(0.18257418583505564) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.7071067811865471) * x[0]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(-0.5773502691896253) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.7071067811865467) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.18257418583505505) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.447213595499958) * x[1]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.5773502691896258) * x[1]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.7302967433402211) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896256) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.6324555320336757) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.7745966692414835) * x[2]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.632455532033676) * x[2]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.5773502691896267) * x[3]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.7302967433402221) * x[3]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.44721359549995854) * x[3]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.5773502691896261) * x[3]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(-0.7071067811865476) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.18257418583505516) * x[4]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.5773502691896257) * x[4]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(0.1825741858350553) * x[4]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.7071067811865474) * x[4]; out[6] = fmaf(t, e[2], out[6]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[3], const float (&g)[7],
                                             float (&dx)[5], float (&de)[3]) {
    { const float t = static_cast<float>(0.18257418583505564) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.7071067811865471) * g[6]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.5773502691896253) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865467) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.18257418583505505) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.447213595499958) * g[3]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.5773502691896258) * g[5]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.7302967433402211) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.5773502691896256) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.6324555320336757) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.7745966692414835) * g[3]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.632455532033676) * g[4]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.5773502691896267) * g[1]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.7302967433402221) * g[4]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.44721359549995854) * g[3]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.5773502691896261) * g[5]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865476) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.18257418583505516) * g[2]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.5773502691896257) * g[5]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.1825741858350553) * g[4]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865474) * g[6]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
  }
};

// triple 17: (2, 2, 0), 5 coefficients
template <>
struct CgBlock<2, 2, 0> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[5], float (&out)[1]) {
    { const float t = static_cast<float>(0.4472135954999572) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.4472135954999578) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.44721359549995754) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.44721359549995887) * x[3]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.4472135954999583) * x[4]; out[0] = fmaf(t, e[4], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[5], const float (&g)[1],
                                             float (&dx)[5], float (&de)[5]) {
    { const float t = static_cast<float>(0.4472135954999572) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.4472135954999578) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.44721359549995754) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.44721359549995887) * g[0]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(0.4472135954999583) * g[0]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
  }
};

// triple 18: (2, 2, 1), 16 coefficients
template <>
struct CgBlock<2, 2, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[5], float (&out)[3]) {
    { const float t = static_cast<float>(0.3162277660168373) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.31622776601683755) * x[0]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.6324555320336753) * x[0]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(-0.3162277660168377) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.5477225575051659) * x[1]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.31622776601683844) * x[1]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.31622776601683783) * x[1]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.5477225575051661) * x[2]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.5477225575051666) * x[2]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.3162277660168378) * x[3]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.3162277660168381) * x[3]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.5477225575051666) * x[3]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.31622776601683855) * x[3]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.6324555320336751) * x[4]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.3162277660168378) * x[4]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.3162277660168386) * x[4]; out[0] = fmaf(t, e[3], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[5], const float (&g)[3],
                                             float (&dx)[5], float (&de)[5]) {
    { const float t = static_cast<float>(0.3162277660168373) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.31622776601683755) * g[2]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.6324555320336753) * g[1]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.3162277660168377) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.5477225575051659) * g[2]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.31622776601683844) * g[1]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.31622776601683783) * g[2]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.5477225575051661) * g[2]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.5477225575051666) * g[0]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.3162277660168378) * g[2]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.3162277660168381) * g[1]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.5477225575051666) * g[0]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.31622776601683855) * g[0]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.6324555320336751) * g[1]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.3162277660168378) * g[2]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.3162277660168386) * g[0]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
  }
};

// triple 19: (2, 2, 2), 25 coefficients
template <>
struct CgBlock<2, 2, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[5], float (&out)[5]) {
    { const float t = static_cast<float>(0.534522483824848) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.4629100498862754) * x[0]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.5345224838248475) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.462910049886275) * x[0]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.4629100498862763) * x[1]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.26726124191242495) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.462910049886276) * x[1]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.2672612419124247) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.46291004988627543) * x[1]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.4629100498862752) * x[1]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.5345224838248479) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.26726124191242456) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.5345224838248488) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.26726124191242445) * x[2]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(0.5345224838248492) * x[2]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.4629100498862759) * x[3]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.46291004988627577) * x[3]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.2672612419124244) * x[3]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.2672612419124245) * x[3]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.46291004988627726) * x[3]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.46291004988627715) * x[3]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.4629100498862749) * x[4]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.5345224838248489) * x[4]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.46291004988627665) * x[4]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(0.5345224838248497) * x[4]; out[2] = fmaf(t, e[4], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[5], const float (&g)[5],
                                             float (&dx)[5], float (&de)[5]) {
    { const float t = static_cast<float>(0.534522483824848) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.4629100498862754) * g[3]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.5345224838248475) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.462910049886275) * g[1]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.4629100498862763) * g[3]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.26726124191242495) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.462910049886276) * g[4]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.2672612419124247) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.46291004988627543) * g[0]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(0.4629100498862752) * g[1]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.5345224838248479) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.26726124191242456) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.5345224838248488) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.26726124191242445) * g[3]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.5345224838248492) * g[4]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.4629100498862759) * g[1]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.46291004988627577) * g[0]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.2672612419124244) * g[3]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.2672612419124245) * g[2]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.46291004988627726) * g[4]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.46291004988627715) * g[3]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.4629100498862749) * g[1]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.5345224838248489) * g[4]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.46291004988627665) * g[3]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(0.5345224838248497) * g[2]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
  }
};

// triple 20: (2, 2, 3), 28 coefficients
template <>
struct CgBlock<2, 2, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[5], float (&out)[7]) {
    { const float t = static_cast<float>(0.4999999999999998) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.3872983346207412) * x[0]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.7071067811865465) * x[0]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(-0.3872983346207409) * x[0]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(0.4999999999999994) * x[0]; out[6] = fmaf(t, e[3], out[6]); }
    { const float t = static_cast<float>(0.31622776601683744) * x[0]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.49999999999999967) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.38729833462074115) * x[1]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.4472135954999581) * x[1]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.6324555320336771) * x[1]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(-0.38729833462074215) * x[1]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.5000000000000003) * x[1]; out[6] = fmaf(t, e[4], out[6]); }
    { const float t = static_cast<float>(-0.7071067811865462) * x[2]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.4472135954999592) * x[2]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.4472135954999586) * x[2]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.7071067811865476) * x[2]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.3872983346207412) * x[3]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.49999999999999956) * x[3]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(0.6324555320336772) * x[3]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.4472135954999584) * x[3]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.5000000000000003) * x[3]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.38729833462074215) * x[3]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.31622776601683744) * x[4]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.38729833462074187) * x[4]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.5000000000000001) * x[4]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(-0.707106781186548) * x[4]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.5000000000000007) * x[4]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.3872983346207423) * x[4]; out[2] = fmaf(t, e[3], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[5], const float (&g)[7],
                                             float (&dx)[5], float (&de)[5]) {
    { const float t = static_cast<float>(0.4999999999999998) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.3872983346207412) * g[2]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.7071067811865465) * g[5]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.3872983346207409) * g[4]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.4999999999999994) * g[6]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.31622776601683744) * g[3]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.49999999999999967) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.38729833462074115) * g[2]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.4472135954999581) * g[4]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.6324555320336771) * g[3]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.38729833462074215) * g[4]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.5000000000000003) * g[6]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.7071067811865462) * g[5]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.4472135954999592) * g[4]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.4472135954999586) * g[2]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.7071067811865476) * g[1]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.3872983346207412) * g[4]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.49999999999999956) * g[6]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(0.6324555320336772) * g[3]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.4472135954999584) * g[2]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(0.5000000000000003) * g[0]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.38729833462074215) * g[2]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.31622776601683744) * g[3]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.38729833462074187) * g[4]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.5000000000000001) * g[6]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.707106781186548) * g[1]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.5000000000000007) * g[0]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(0.3872983346207423) * g[2]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
  }
};

// triple 21: (2, 3, 1), 21 coefficients
template <>
struct CgBlock<2, 3, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[7], float (&out)[3]) {
    { const float t = static_cast<float>(0.46291004988627543) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.37796447300922625) * x[0]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.11952286093343897) * x[0]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.11952286093343874) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.4629100498862753) * x[0]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(0.3779644730092275) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.47809144373375784) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.2927700218845607) * x[1]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.37796447300922736) * x[1]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.4140393356054121) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.5070925528371103) * x[2]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.4140393356054127) * x[2]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.3779644730092276) * x[3]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.2927700218845598) * x[3]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.4780914437337579) * x[3]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.37796447300922786) * x[3]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.46291004988627504) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.1195228609334395) * x[4]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.11952286093343904) * x[4]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.37796447300922725) * x[4]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(0.46291004988627543) * x[4]; out[2] = fmaf(t, e[6], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[7], const float (&g)[3],
                                             float (&dx)[5], float (&de)[7]) {
    { const float t = static_cast<float>(0.46291004988627543) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.37796447300922625) * g[1]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.11952286093343897) * g[2]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.11952286093343874) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.4629100498862753) * g[0]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(0.3779644730092275) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.47809144373375784) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.2927700218845607) * g[0]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.37796447300922736) * g[0]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(0.4140393356054121) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.5070925528371103) * g[1]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.4140393356054127) * g[2]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.3779644730092276) * g[0]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.2927700218845598) * g[2]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(0.4780914437337579) * g[1]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.37796447300922786) * g[2]; dx[3] = fmaf(t, e[5], dx[3]); de[5] = fmaf(t, x[3], de[5]); }
    { const float t = static_cast<float>(0.46291004988627504) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.1195228609334395) * g[0]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.11952286093343904) * g[2]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.37796447300922725) * g[1]; dx[4] = fmaf(t, e[5], dx[4]); de[5] = fmaf(t, x[4], de[5]); }
    { const float t = static_cast<float>(0.46291004988627543) * g[2]; dx[4] = fmaf(t, e[6], dx[4]); de[6] = fmaf(t, x[4], de[6]); }
  }
};

// triple 22: (2, 3, 2), 28 coefficients
template <>
struct CgBlock<2, 3, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[7], float (&out)[5]) {
    { const float t = static_cast<float>(0.42257712736425773) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.32732683535398815) * x[0]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.2672612419124241) * x[0]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.3273268353539883) * x[0]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.5976143046671953) * x[0]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.422577127364258) * x[0]; out[3] = fmaf(t, e[6], out[3]); }
    { const float t = static_cast<float>(-0.4225771273642579) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.3273268353539882) * x[1]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.5345224838248498) * x[1]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(0.37796447300922764) * x[1]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.3273268353539887) * x[1]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.4225771273642584) * x[1]; out[4] = fmaf(t, e[6], out[4]); }
    { const float t = static_cast<float>(0.5976143046671969) * x[2]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.37796447300922753) * x[2]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.37796447300922764) * x[2]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(-0.5976143046671958) * x[2]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.42257712736425895) * x[3]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.3779644730092277) * x[3]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.32732683535398904) * x[3]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(0.5345224838248499) * x[3]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.3273268353539885) * x[3]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.42257712736425834) * x[3]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(-0.4225771273642589) * x[4]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.597614304667197) * x[4]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.32732683535398904) * x[4]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.26726124191242406) * x[4]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.32732683535398893) * x[4]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.42257712736425834) * x[4]; out[1] = fmaf(t, e[6], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[7], const float (&g)[5],
                                             float (&dx)[5], float (&de)[7]) {
    { const float t = static_cast<float>(0.42257712736425773) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.32732683535398815) * g[1]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.2672612419124241) * g[4]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.3273268353539883) * g[3]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.5976143046671953) * g[2]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(0.422577127364258) * g[3]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(-0.4225771273642579) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.3273268353539882) * g[0]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.5345224838248498) * g[3]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(0.37796447300922764) * g[2]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.3273268353539887) * g[4]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.4225771273642584) * g[4]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(0.5976143046671969) * g[4]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.37796447300922753) * g[3]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.37796447300922764) * g[1]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.5976143046671958) * g[0]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.42257712736425895) * g[4]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.3779644730092277) * g[2]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.32732683535398904) * g[4]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(0.5345224838248499) * g[1]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(0.3273268353539885) * g[0]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.42257712736425834) * g[0]; dx[3] = fmaf(t, e[6], dx[3]); de[6] = fmaf(t, x[3], de[6]); }
    { const float t = static_cast<float>(-0.4225771273642589) * g[3]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.597614304667197) * g[2]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.32732683535398904) * g[3]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.26726124191242406) * g[0]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(0.32732683535398893) * g[1]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.42257712736425834) * g[1]; dx[4] = fmaf(t, e[6], dx[4]); de[6] = fmaf(t, x[4], de[6]); }
  }
};

// triple 23: (2, 3, 3), 41 coefficients
template <>
struct CgBlock<2, 3, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[5], const float (&e)[7], float (&out)[7]) {
    { const float t = static_cast<float>(0.28867513459481237) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.5773502691896253) * x[0]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.44721359549995726) * x[0]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.2886751345948125) * x[0]; out[6] = fmaf(t, e[2], out[6]); }
    { const float t = static_cast<float>(0.5773502691896257) * x[0]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.2886751345948122) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.44721359549995787) * x[0]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.28867513459481237) * x[0]; out[2] = fmaf(t, e[6], out[2]); }
    { const float t = static_cast<float>(-0.4564354645876388) * x[1]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.3535533905932742) * x[1]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.456435464587639) * x[1]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(-0.18257418583505577) * x[1]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(0.35355339059327356) * x[1]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(-0.18257418583505577) * x[1]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.3535533905932742) * x[1]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(-0.4564354645876389) * x[1]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.35355339059327395) * x[1]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.4564354645876388) * x[1]; out[1] = fmaf(t, e[6], out[1]); }
    { const float t = static_cast<float>(0.6454972243679025) * x[2]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.38729833462074176) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.5163977794943226) * x[2]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(-0.38729833462074137) * x[2]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(0.6454972243679022) * x[2]; out[6] = fmaf(t, e[6], out[6]); }
    { const float t = static_cast<float>(-0.4564354645876387) * x[3]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.4564354645876388) * x[3]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.35355339059327406) * x[3]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.35355339059327423) * x[3]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.1825741858350555) * x[3]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.1825741858350556) * x[3]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.35355339059327395) * x[3]; out[5] = fmaf(t, e[4], out[5]); }
    { const float t = static_cast<float>(-0.35355339059327395) * x[3]; out[4] = fmaf(t, e[5], out[4]); }
    { const float t = static_cast<float>(-0.456435464587639) * x[3]; out[6] = fmaf(t, e[5], out[6]); }
    { const float t = static_cast<float>(-0.45643546458763906) * x[3]; out[5] = fmaf(t, e[6], out[5]); }
    { const float t = static_cast<float>(0.2886751345948127) * x[4]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.2886751345948127) * x[4]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.447213595499958) * x[4]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.5773502691896263) * x[4]; out[5] = fmaf(t, e[3], out[5]); }
    { const float t = static_cast<float>(-0.44721359549995787) * x[4]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(0.2886751345948128) * x[4]; out[6] = fmaf(t, e[4], out[6]); }
    { const float t = static_cast<float>(0.5773502691896263) * x[4]; out[3] = fmaf(t, e[5], out[3]); }
    { const float t = static_cast<float>(0.2886751345948126) * x[4]; out[4] = fmaf(t, e[6], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[5], const float (&e)[7], const float (&g)[7],
                                             float (&dx)[5], float (&de)[7]) {
    { const float t = static_cast<float>(0.28867513459481237) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.5773502691896253) * g[3]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.44721359549995726) * g[4]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.2886751345948125) * g[6]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.5773502691896257) * g[1]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.2886751345948122) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.44721359549995787) * g[2]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.28867513459481237) * g[2]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(-0.4564354645876388) * g[5]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.3535533905932742) * g[4]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.456435464587639) * g[6]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.18257418583505577) * g[3]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.35355339059327356) * g[5]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.18257418583505577) * g[2]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.3535533905932742) * g[1]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.4564354645876389) * g[0]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(0.35355339059327395) * g[2]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(0.4564354645876388) * g[1]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(0.6454972243679025) * g[0]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.38729833462074176) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.5163977794943226) * g[3]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(-0.38729833462074137) * g[4]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.6454972243679022) * g[6]; dx[2] = fmaf(t, e[6], dx[2]); de[6] = fmaf(t, x[2], de[6]); }
    { const float t = static_cast<float>(-0.4564354645876387) * g[1]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.4564354645876388) * g[0]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.35355339059327406) * g[2]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.35355339059327423) * g[1]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.1825741858350555) * g[4]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.1825741858350556) * g[3]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.35355339059327395) * g[5]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.35355339059327395) * g[4]; dx[3] = fmaf(t, e[5], dx[3]); de[5] = fmaf(t, x[3], de[5]); }
    { const float t = static_cast<float>(-0.456435464587639) * g[6]; dx[3] = fmaf(t, e[5], dx[3]); de[5] = fmaf(t, x[3], de[5]); }
    { const float t = static_cast<float>(-0.45643546458763906) * g[5]; dx[3] = fmaf(t, e[6], dx[3]); de[6] = fmaf(t, x[3], de[6]); }
    { const float t = static_cast<float>(0.2886751345948127) * g[2]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.2886751345948127) * g[0]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.447213595499958) * g[2]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.5773502691896263) * g[5]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.44721359549995787) * g[4]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.2886751345948128) * g[6]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.5773502691896263) * g[3]; dx[4] = fmaf(t, e[5], dx[4]); de[5] = fmaf(t, x[4], de[5]); }
    { const float t = static_cast<float>(0.2886751345948126) * g[4]; dx[4] = fmaf(t, e[6], dx[4]); de[6] = fmaf(t, x[4], de[6]); }
  }
};

// triple 24: (3, 0, 3), 7 coefficients
template <>
struct CgBlock<3, 0, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[1], float (&out)[7]) {
    { const float t = static_cast<float>(1.0) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.9999999999999997) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(1.0000000000000002) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(1.0000000000000013) * x[3]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(1.0000000000000004) * x[4]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(1.0000000000000007) * x[5]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(0.9999999999999992) * x[6]; out[6] = fmaf(t, e[0], out[6]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[1], const float (&g)[7],
                                             float (&dx)[7], float (&de)[1]) {
    { const float t = static_cast<float>(1.0) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.9999999999999997) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(1.0000000000000002) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(1.0000000000000013) * g[3]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(1.0000000000000004) * g[4]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(1.0000000000000007) * g[5]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(0.9999999999999992) * g[6]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
  }
};

// triple 25: (3, 1, 2), 21 coefficients
template <>
struct CgBlock<3, 1, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[3], float (&out)[5]) {
    { const float t = static_cast<float>(0.5976143046671969) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.5976143046671957) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.4879500364742667) * x[1]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.4879500364742658) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.4879500364742667) * x[1]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.5345224838248491) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.15430334996209236) * x[2]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.6172133998483681) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.15430334996209175) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.3779644730092279) * x[3]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.6546536707079769) * x[3]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.37796447300922764) * x[3]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.15430334996209144) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.6172133998483685) * x[4]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.5345224838248491) * x[4]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.1543033499620917) * x[4]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.487950036474267) * x[5]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.48795003647426693) * x[5]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.4879500364742669) * x[5]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.5976143046671956) * x[6]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.5976143046671972) * x[6]; out[4] = fmaf(t, e[2], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[3], const float (&g)[5],
                                             float (&dx)[7], float (&de)[3]) {
    { const float t = static_cast<float>(0.5976143046671969) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.5976143046671957) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.4879500364742667) * g[3]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.4879500364742658) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.4879500364742667) * g[1]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.5345224838248491) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.15430334996209236) * g[4]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.6172133998483681) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.15430334996209175) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.3779644730092279) * g[1]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(0.6546536707079769) * g[2]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.37796447300922764) * g[3]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.15430334996209144) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.6172133998483685) * g[3]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.5345224838248491) * g[2]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.1543033499620917) * g[4]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.487950036474267) * g[1]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(0.48795003647426693) * g[4]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.4879500364742669) * g[3]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(-0.5976143046671956) * g[0]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(0.5976143046671972) * g[4]; dx[6] = fmaf(t, e[2], dx[6]); de[2] = fmaf(t, x[6], de[2]); }
  }
};

// triple 26: (3, 1, 3), 26 coefficients
template <>
struct CgBlock<3, 1, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[3], float (&out)[7]) {
    { const float t = static_cast<float>(0.3535533905932738) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.8660254037844375) * x[0]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(-0.3535533905932738) * x[0]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(-0.3535533905932746) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.4564354645876384) * x[1]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.5773502691896261) * x[1]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(-0.45643546458763856) * x[1]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.35355339059327345) * x[1]; out[6] = fmaf(t, e[2], out[6]); }
    { const float t = static_cast<float>(-0.4564354645876384) * x[2]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.2886751345948127) * x[2]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.7071067811865476) * x[2]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.45643546458763856) * x[2]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(-0.7071067811865477) * x[3]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.7071067811865474) * x[3]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.7071067811865485) * x[4]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.4564354645876391) * x[4]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.288675134594813) * x[4]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.4564354645876388) * x[4]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.45643546458763834) * x[5]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.3535533905932742) * x[5]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(-0.5773502691896261) * x[5]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.3535533905932738) * x[5]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.45643546458763845) * x[5]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.3535533905932735) * x[6]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.8660254037844387) * x[6]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.353553390593274) * x[6]; out[1] = fmaf(t, e[2], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[3], const float (&g)[7],
                                             float (&dx)[7], float (&de)[3]) {
    { const float t = static_cast<float>(0.3535533905932738) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.8660254037844375) * g[6]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.3535533905932738) * g[5]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.3535533905932746) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.4564354645876384) * g[2]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.5773502691896261) * g[5]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.45643546458763856) * g[4]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.35355339059327345) * g[6]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.4564354645876384) * g[1]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.2886751345948127) * g[4]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.7071067811865476) * g[3]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.45643546458763856) * g[5]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.7071067811865477) * g[4]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(0.7071067811865474) * g[2]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(0.7071067811865485) * g[3]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.4564354645876391) * g[5]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.288675134594813) * g[2]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.4564354645876388) * g[1]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.45643546458763834) * g[4]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(-0.3535533905932742) * g[6]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(-0.5773502691896261) * g[1]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.3535533905932738) * g[0]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(0.45643546458763845) * g[2]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(0.3535533905932735) * g[5]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(-0.8660254037844387) * g[0]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(0.353553390593274) * g[1]; dx[6] = fmaf(t, e[2], dx[6]); de[2] = fmaf(t, x[6], de[2]); }
  }
};

// triple 27: (3, 2, 1), 21 coefficients
template <>
struct CgBlock<3, 2, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[5], float (&out)[3]) {
    { const float t = static_cast<float>(0.46291004988627554) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.4629100498862757) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.3779644730092266) * x[1]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.377964473009227) * x[1]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.37796447300922764) * x[1]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.11952286093343933) * x[2]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.4780914437337581) * x[2]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.4140393356054126) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.11952286093343956) * x[2]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.29277002188456025) * x[3]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.5070925528371102) * x[3]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.29277002188455975) * x[3]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.1195228609334392) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.4140393356054125) * x[4]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.47809144373375734) * x[4]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.11952286093343921) * x[4]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.3779644730092272) * x[5]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.3779644730092276) * x[5]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.377964473009227) * x[5]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(-0.46291004988627493) * x[6]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.46291004988627543) * x[6]; out[2] = fmaf(t, e[4], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[5], const float (&g)[3],
                                             float (&dx)[7], float (&de)[5]) {
    { const float t = static_cast<float>(0.46291004988627554) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.4629100498862757) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.3779644730092266) * g[1]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.377964473009227) * g[2]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.37796447300922764) * g[0]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.11952286093343933) * g[2]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(0.4780914437337581) * g[1]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.4140393356054126) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.11952286093343956) * g[0]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.29277002188456025) * g[0]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.5070925528371102) * g[1]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.29277002188455975) * g[2]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.1195228609334392) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.4140393356054125) * g[2]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.47809144373375734) * g[1]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.11952286093343921) * g[2]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(-0.3779644730092272) * g[0]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.3779644730092276) * g[2]; dx[5] = fmaf(t, e[3], dx[5]); de[3] = fmaf(t, x[5], de[3]); }
    { const float t = static_cast<float>(0.377964473009227) * g[1]; dx[5] = fmaf(t, e[4], dx[5]); de[4] = fmaf(t, x[5], de[4]); }
    { const float t = static_cast<float>(-0.46291004988627493) * g[0]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(0.46291004988627543) * g[2]; dx[6] = fmaf(t, e[4], dx[6]); de[4] = fmaf(t, x[6], de[4]); }
  }
};

// triple 28: (3, 2, 2), 28 coefficients
template <>
struct CgBlock<3, 2, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[5], float (&out)[5]) {
    { const float t = static_cast<float>(0.4225771273642573) * x[0]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.42257712736425795) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.42257712736425923) * x[0]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.4225771273642588) * x[0]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.5976143046671962) * x[1]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.5976143046671964) * x[1]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.3273268353539885) * x[2]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.3273268353539882) * x[2]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.37796447300922764) * x[2]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.37796447300922736) * x[2]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.3273268353539887) * x[2]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(0.3273268353539894) * x[2]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.2672612419124241) * x[3]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.5345224838248498) * x[3]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.5345224838248499) * x[3]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.26726124191242406) * x[3]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.32732683535398893) * x[4]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.3779644730092273) * x[4]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.32732683535398865) * x[4]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.3779644730092273) * x[4]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.3273268353539885) * x[4]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.32732683535398865) * x[4]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.5976143046671959) * x[5]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.5976143046671959) * x[5]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.4225771273642584) * x[6]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.4225771273642585) * x[6]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.42257712736425856) * x[6]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.42257712736425834) * x[6]; out[1] = fmaf(t, e[4], out[1]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[5], const float (&g)[5],
                                             float (&dx)[7], float (&de)[5]) {
    { const float t = static_cast<float>(0.4225771273642573) * g[1]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.42257712736425795) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.42257712736425923) * g[4]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(-0.4225771273642588) * g[3]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.5976143046671962) * g[4]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.5976143046671964) * g[2]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.3273268353539885) * g[1]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.3273268353539882) * g[0]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.37796447300922764) * g[3]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.37796447300922736) * g[2]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(-0.3273268353539887) * g[4]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.3273268353539894) * g[3]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.2672612419124241) * g[4]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.5345224838248498) * g[3]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(0.5345224838248499) * g[1]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.26726124191242406) * g[0]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(-0.32732683535398893) * g[3]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(0.3779644730092273) * g[2]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.32732683535398865) * g[4]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.3779644730092273) * g[1]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.3273268353539885) * g[0]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(0.32732683535398865) * g[1]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.5976143046671959) * g[2]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(-0.5976143046671959) * g[0]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(0.4225771273642584) * g[3]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(-0.4225771273642585) * g[4]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(-0.42257712736425856) * g[0]; dx[6] = fmaf(t, e[3], dx[6]); de[3] = fmaf(t, x[6], de[3]); }
    { const float t = static_cast<float>(0.42257712736425834) * g[1]; dx[6] = fmaf(t, e[4], dx[6]); de[4] = fmaf(t, x[6], de[4]); }
  }
};

// triple 29: (3, 2, 3), 41 coefficients
template <>
struct CgBlock<3, 2, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[5], float (&out)[7]) {
    { const float t = static_cast<float>(0.2886751345948126) * x[0]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.4564354645876387) * x[0]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(0.6454972243679027) * x[0]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.45643546458763845) * x[0]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.2886751345948127) * x[0]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.5773502691896252) * x[1]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.35355339059327445) * x[1]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(0.45643546458763934) * x[1]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(-0.45643546458763856) * x[1]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.35355339059327406) * x[1]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.447213595499957) * x[2]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.2886751345948125) * x[2]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(-0.18257418583505516) * x[2]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.35355339059327395) * x[2]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(-0.38729833462074204) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.35355339059327406) * x[2]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(0.28867513459481314) * x[2]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.44721359549995865) * x[2]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.5773502691896253) * x[3]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.18257418583505508) * x[3]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.5163977794943224) * x[3]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.18257418583505577) * x[3]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(0.5773502691896262) * x[3]; out[5] = fmaf(t, e[4], out[5]); }
    { const float t = static_cast<float>(0.2886751345948122) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.4472135954999572) * x[4]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.3535533905932744) * x[4]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.3872983346207411) * x[4]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.18257418583505575) * x[4]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(-0.3535533905932735) * x[4]; out[5] = fmaf(t, e[3], out[5]); }
    { const float t = static_cast<float>(-0.4472135954999584) * x[4]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(0.28867513459481314) * x[4]; out[6] = fmaf(t, e[4], out[6]); }
    { const float t = static_cast<float>(-0.4564354645876388) * x[5]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.353553390593274) * x[5]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.3535533905932737) * x[5]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.4564354645876384) * x[5]; out[6] = fmaf(t, e[3], out[6]); }
    { const float t = static_cast<float>(0.5773502691896263) * x[5]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.28867513459481225) * x[6]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.4564354645876386) * x[6]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.6454972243679025) * x[6]; out[6] = fmaf(t, e[2], out[6]); }
    { const float t = static_cast<float>(-0.4564354645876386) * x[6]; out[5] = fmaf(t, e[3], out[5]); }
    { const float t = static_cast<float>(0.2886751345948128) * x[6]; out[4] = fmaf(t, e[4], out[4]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[5], const float (&g)[7],
                                             float (&dx)[7], float (&de)[5]) {
    { const float t = static_cast<float>(0.2886751345948126) * g[4]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.4564354645876387) * g[5]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.6454972243679027) * g[0]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.45643546458763845) * g[1]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.2886751345948127) * g[2]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(0.5773502691896252) * g[3]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.35355339059327445) * g[4]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.45643546458763934) * g[6]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(-0.45643546458763856) * g[0]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.35355339059327406) * g[2]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.447213595499957) * g[4]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.2886751345948125) * g[6]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.18257418583505516) * g[3]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.35355339059327395) * g[5]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.38729833462074204) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.35355339059327406) * g[1]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.28867513459481314) * g[0]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.44721359549995865) * g[2]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.5773502691896253) * g[1]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.18257418583505508) * g[2]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.5163977794943224) * g[3]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.18257418583505577) * g[4]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(0.5773502691896262) * g[5]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.2886751345948122) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.4472135954999572) * g[2]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.3535533905932744) * g[1]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.3872983346207411) * g[4]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.18257418583505575) * g[3]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.3535533905932735) * g[5]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.4472135954999584) * g[4]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.28867513459481314) * g[6]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(-0.4564354645876388) * g[0]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.353553390593274) * g[2]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(-0.3535533905932737) * g[4]; dx[5] = fmaf(t, e[3], dx[5]); de[3] = fmaf(t, x[5], de[3]); }
    { const float t = static_cast<float>(-0.4564354645876384) * g[6]; dx[5] = fmaf(t, e[3], dx[5]); de[3] = fmaf(t, x[5], de[3]); }
    { const float t = static_cast<float>(0.5773502691896263) * g[3]; dx[5] = fmaf(t, e[4], dx[5]); de[4] = fmaf(t, x[5], de[4]); }
    { const float t = static_cast<float>(-0.28867513459481225) * g[2]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(0.4564354645876386) * g[1]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(0.6454972243679025) * g[6]; dx[6] = fmaf(t, e[2], dx[6]); de[2] = fmaf(t, x[6], de[2]); }
    { const float t = static_cast<float>(-0.4564354645876386) * g[5]; dx[6] = fmaf(t, e[3], dx[6]); de[3] = fmaf(t, x[6], de[3]); }
    { const float t = static_cast<float>(0.2886751345948128) * g[4]; dx[6] = fmaf(t, e[4], dx[6]); de[4] = fmaf(t, x[6], de[4]); }
  }
};

// triple 30: (3, 3, 0), 7 coefficients
template <>
struct CgBlock<3, 3, 0> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[7], float (&out)[1]) {
    { const float t = static_cast<float>(0.3779644730092269) * x[0]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.37796447300922753) * x[1]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.3779644730092269) * x[2]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.37796447300922753) * x[3]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(0.37796447300922714) * x[4]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.37796447300922725) * x[5]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.37796447300922714) * x[6]; out[0] = fmaf(t, e[6], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[7], const float (&g)[1],
                                             float (&dx)[7], float (&de)[7]) {
    { const float t = static_cast<float>(0.3779644730092269) * g[0]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(0.37796447300922753) * g[0]; dx[1] = fmaf(t, e[1], dx[1]); de[1] = fmaf(t, x[1], de[1]); }
    { const float t = static_cast<float>(0.3779644730092269) * g[0]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.37796447300922753) * g[0]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(0.37796447300922714) * g[0]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(0.37796447300922725) * g[0]; dx[5] = fmaf(t, e[5], dx[5]); de[5] = fmaf(t, x[5], de[5]); }
    { const float t = static_cast<float>(0.37796447300922714) * g[0]; dx[6] = fmaf(t, e[6], dx[6]); de[6] = fmaf(t, x[6], de[6]); }
  }
};

// triple 31: (3, 3, 1), 26 coefficients
template <>
struct CgBlock<3, 3, 1> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[7], float (&out)[3]) {
    { const float t = static_cast<float>(0.2314550249431381) * x[0]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.23145502494313783) * x[0]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.5669467095138409) * x[0]; out[1] = fmaf(t, e[6], out[1]); }
    { const float t = static_cast<float>(-0.2314550249431382) * x[1]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(0.29880715233359906) * x[1]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.2988071523335983) * x[1]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.3779644730092274) * x[1]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.23145502494313763) * x[1]; out[2] = fmaf(t, e[6], out[2]); }
    { const float t = static_cast<float>(-0.2988071523335985) * x[2]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.46291004988627527) * x[2]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.18898223650461368) * x[2]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(-0.2988071523335983) * x[2]; out[2] = fmaf(t, e[5], out[2]); }
    { const float t = static_cast<float>(0.4629100498862757) * x[3]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(-0.4629100498862762) * x[3]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.29880715233359834) * x[4]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.18898223650461354) * x[4]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.462910049886276) * x[4]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.29880715233359845) * x[4]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.23145502494313783) * x[5]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.3779644730092271) * x[5]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(0.2988071523335983) * x[5]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.29880715233359834) * x[5]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.23145502494313772) * x[5]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(-0.5669467095138406) * x[6]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.23145502494313772) * x[6]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(0.2314550249431379) * x[6]; out[0] = fmaf(t, e[5], out[0]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[7], const float (&g)[3],
                                             float (&dx)[7], float (&de)[7]) {
    { const float t = static_cast<float>(0.2314550249431381) * g[0]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.23145502494313783) * g[2]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(0.5669467095138409) * g[1]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(-0.2314550249431382) * g[0]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.29880715233359906) * g[0]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(-0.2988071523335983) * g[2]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.3779644730092274) * g[1]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(-0.23145502494313763) * g[2]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(-0.2988071523335985) * g[0]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.46291004988627527) * g[2]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(0.18898223650461368) * g[1]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.2988071523335983) * g[2]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.4629100498862757) * g[2]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.4629100498862762) * g[0]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.29880715233359834) * g[2]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.18898223650461354) * g[1]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(0.462910049886276) * g[0]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.29880715233359845) * g[0]; dx[4] = fmaf(t, e[5], dx[4]); de[5] = fmaf(t, x[4], de[5]); }
    { const float t = static_cast<float>(0.23145502494313783) * g[2]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(-0.3779644730092271) * g[1]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.2988071523335983) * g[2]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(0.29880715233359834) * g[0]; dx[5] = fmaf(t, e[4], dx[5]); de[4] = fmaf(t, x[5], de[4]); }
    { const float t = static_cast<float>(-0.23145502494313772) * g[0]; dx[5] = fmaf(t, e[6], dx[5]); de[6] = fmaf(t, x[5], de[6]); }
    { const float t = static_cast<float>(-0.5669467095138406) * g[1]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(0.23145502494313772) * g[2]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(0.2314550249431379) * g[0]; dx[6] = fmaf(t, e[5], dx[6]); de[5] = fmaf(t, x[6], de[5]); }
  }
};

// triple 32: (3, 3, 2), 41 coefficients
template <>
struct CgBlock<3, 3, 2> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[7], float (&out)[5]) {
    { const float t = static_cast<float>(0.5455447255899802) * x[0]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(-0.3857583749052298) * x[0]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.24397501823713327) * x[0]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(0.243975018237133) * x[0]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.38575837490523013) * x[0]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.38575837490522974) * x[1]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(-0.2988071523335985) * x[1]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(0.4879500364742663) * x[1]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.29880715233359884) * x[1]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.38575837490523024) * x[1]; out[1] = fmaf(t, e[6], out[1]); }
    { const float t = static_cast<float>(0.24397501823713313) * x[2]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(-0.29880715233359856) * x[2]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(-0.3273268353539885) * x[2]; out[2] = fmaf(t, e[2], out[2]); }
    { const float t = static_cast<float>(0.37796447300922714) * x[2]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(-0.15430334996209197) * x[2]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.3779644730092268) * x[2]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(0.29880715233359867) * x[2]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.24397501823713297) * x[2]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(0.48795003647426616) * x[3]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(-0.15430334996209188) * x[3]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.43643578047198506) * x[3]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(-0.15430334996209205) * x[3]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(0.48795003647426705) * x[3]; out[4] = fmaf(t, e[5], out[4]); }
    { const float t = static_cast<float>(0.24397501823713313) * x[4]; out[0] = fmaf(t, e[0], out[0]); }
    { const float t = static_cast<float>(-0.2988071523335986) * x[4]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.37796447300922664) * x[4]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(-0.15430334996209194) * x[4]; out[3] = fmaf(t, e[3], out[3]); }
    { const float t = static_cast<float>(-0.3273268353539882) * x[4]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(-0.3779644730092273) * x[4]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.29880715233359867) * x[4]; out[3] = fmaf(t, e[5], out[3]); }
    { const float t = static_cast<float>(0.2439750182371334) * x[4]; out[4] = fmaf(t, e[6], out[4]); }
    { const float t = static_cast<float>(-0.38575837490523024) * x[5]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(0.29880715233359845) * x[5]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(0.48795003647426693) * x[5]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.29880715233359856) * x[5]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.38575837490523024) * x[5]; out[3] = fmaf(t, e[6], out[3]); }
    { const float t = static_cast<float>(0.3857583749052302) * x[6]; out[1] = fmaf(t, e[1], out[1]); }
    { const float t = static_cast<float>(-0.24397501823713308) * x[6]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.24397501823713336) * x[6]; out[4] = fmaf(t, e[4], out[4]); }
    { const float t = static_cast<float>(-0.38575837490522985) * x[6]; out[3] = fmaf(t, e[5], out[3]); }
    { const float t = static_cast<float>(0.5455447255899812) * x[6]; out[2] = fmaf(t, e[6], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[7], const float (&g)[5],
                                             float (&dx)[7], float (&de)[7]) {
    { const float t = static_cast<float>(0.5455447255899802) * g[2]; dx[0] = fmaf(t, e[0], dx[0]); de[0] = fmaf(t, x[0], de[0]); }
    { const float t = static_cast<float>(-0.3857583749052298) * g[3]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(0.24397501823713327) * g[4]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(0.243975018237133) * g[0]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.38575837490523013) * g[1]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(-0.38575837490522974) * g[3]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(-0.2988071523335985) * g[3]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.4879500364742663) * g[0]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(-0.29880715233359884) * g[1]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(0.38575837490523024) * g[1]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(0.24397501823713313) * g[4]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.29880715233359856) * g[3]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(-0.3273268353539885) * g[2]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(0.37796447300922714) * g[4]; dx[2] = fmaf(t, e[2], dx[2]); de[2] = fmaf(t, x[2], de[2]); }
    { const float t = static_cast<float>(-0.15430334996209197) * g[1]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(-0.3779644730092268) * g[0]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(0.29880715233359867) * g[1]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(-0.24397501823713297) * g[0]; dx[2] = fmaf(t, e[6], dx[2]); de[6] = fmaf(t, x[2], de[6]); }
    { const float t = static_cast<float>(0.48795003647426616) * g[0]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.15430334996209188) * g[1]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(-0.43643578047198506) * g[2]; dx[3] = fmaf(t, e[3], dx[3]); de[3] = fmaf(t, x[3], de[3]); }
    { const float t = static_cast<float>(-0.15430334996209205) * g[3]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.48795003647426705) * g[4]; dx[3] = fmaf(t, e[5], dx[3]); de[5] = fmaf(t, x[3], de[5]); }
    { const float t = static_cast<float>(0.24397501823713313) * g[0]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.2988071523335986) * g[1]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(-0.37796447300922664) * g[0]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.15430334996209194) * g[3]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(-0.3273268353539882) * g[2]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(-0.3779644730092273) * g[4]; dx[4] = fmaf(t, e[4], dx[4]); de[4] = fmaf(t, x[4], de[4]); }
    { const float t = static_cast<float>(-0.29880715233359867) * g[3]; dx[4] = fmaf(t, e[5], dx[4]); de[5] = fmaf(t, x[4], de[5]); }
    { const float t = static_cast<float>(0.2439750182371334) * g[4]; dx[4] = fmaf(t, e[6], dx[4]); de[6] = fmaf(t, x[4], de[6]); }
    { const float t = static_cast<float>(-0.38575837490523024) * g[1]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(0.29880715233359845) * g[1]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(0.48795003647426693) * g[4]; dx[5] = fmaf(t, e[3], dx[5]); de[3] = fmaf(t, x[5], de[3]); }
    { const float t = static_cast<float>(-0.29880715233359856) * g[3]; dx[5] = fmaf(t, e[4], dx[5]); de[4] = fmaf(t, x[5], de[4]); }
    { const float t = static_cast<float>(-0.38575837490523024) * g[3]; dx[5] = fmaf(t, e[6], dx[5]); de[6] = fmaf(t, x[5], de[6]); }
    { const float t = static_cast<float>(0.3857583749052302) * g[1]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(-0.24397501823713308) * g[0]; dx[6] = fmaf(t, e[2], dx[6]); de[2] = fmaf(t, x[6], de[2]); }
    { const float t = static_cast<float>(0.24397501823713336) * g[4]; dx[6] = fmaf(t, e[4], dx[6]); de[4] = fmaf(t, x[6], de[4]); }
    { const float t = static_cast<float>(-0.38575837490522985) * g[3]; dx[6] = fmaf(t, e[5], dx[6]); de[5] = fmaf(t, x[6], de[5]); }
    { const float t = static_cast<float>(0.5455447255899812) * g[2]; dx[6] = fmaf(t, e[6], dx[6]); de[6] = fmaf(t, x[6], de[6]); }
  }
};

// triple 33: (3, 3, 3), 42 coefficients
template <>
struct CgBlock<3, 3, 3> {
  static __device__ __forceinline__ void fwd(const float (&x)[7], const float (&e)[7], float (&out)[7]) {
    { const float t = static_cast<float>(0.408248290463863) * x[0]; out[2] = fmaf(t, e[1], out[2]); }
    { const float t = static_cast<float>(-0.4082482904638625) * x[0]; out[1] = fmaf(t, e[2], out[1]); }
    { const float t = static_cast<float>(-0.40824829046386324) * x[0]; out[6] = fmaf(t, e[3], out[6]); }
    { const float t = static_cast<float>(0.40824829046386313) * x[0]; out[5] = fmaf(t, e[4], out[5]); }
    { const float t = static_cast<float>(-0.4082482904638645) * x[0]; out[4] = fmaf(t, e[5], out[4]); }
    { const float t = static_cast<float>(0.4082482904638634) * x[0]; out[3] = fmaf(t, e[6], out[3]); }
    { const float t = static_cast<float>(-0.40824829046386313) * x[1]; out[2] = fmaf(t, e[0], out[2]); }
    { const float t = static_cast<float>(0.40824829046386274) * x[1]; out[0] = fmaf(t, e[2], out[0]); }
    { const float t = static_cast<float>(0.40824829046386324) * x[1]; out[5] = fmaf(t, e[3], out[5]); }
    { const float t = static_cast<float>(0.40824829046386263) * x[1]; out[6] = fmaf(t, e[4], out[6]); }
    { const float t = static_cast<float>(-0.4082482904638632) * x[1]; out[3] = fmaf(t, e[5], out[3]); }
    { const float t = static_cast<float>(-0.4082482904638627) * x[1]; out[4] = fmaf(t, e[6], out[4]); }
    { const float t = static_cast<float>(0.4082482904638629) * x[2]; out[1] = fmaf(t, e[0], out[1]); }
    { const float t = static_cast<float>(-0.40824829046386274) * x[2]; out[0] = fmaf(t, e[1], out[0]); }
    { const float t = static_cast<float>(0.408248290463863) * x[2]; out[4] = fmaf(t, e[3], out[4]); }
    { const float t = static_cast<float>(-0.40824829046386335) * x[2]; out[3] = fmaf(t, e[4], out[3]); }
    { const float t = static_cast<float>(-0.40824829046386246) * x[2]; out[6] = fmaf(t, e[5], out[6]); }
    { const float t = static_cast<float>(0.4082482904638628) * x[2]; out[5] = fmaf(t, e[6], out[5]); }
    { const float t = static_cast<float>(0.40824829046386274) * x[3]; out[6] = fmaf(t, e[0], out[6]); }
    { const float t = static_cast<float>(-0.4082482904638634) * x[3]; out[5] = fmaf(t, e[1], out[5]); }
    { const float t = static_cast<float>(-0.4082482904638629) * x[3]; out[4] = fmaf(t, e[2], out[4]); }
    { const float t = static_cast<float>(0.4082482904638629) * x[3]; out[2] = fmaf(t, e[4], out[2]); }
    { const float t = static_cast<float>(0.40824829046386324) * x[3]; out[1] = fmaf(t, e[5], out[1]); }
    { const float t = static_cast<float>(-0.408248290463863) * x[3]; out[0] = fmaf(t, e[6], out[0]); }
    { const float t = static_cast<float>(-0.40824829046386274) * x[4]; out[5] = fmaf(t, e[0], out[5]); }
    { const float t = static_cast<float>(-0.4082482904638628) * x[4]; out[6] = fmaf(t, e[1], out[6]); }
    { const float t = static_cast<float>(0.4082482904638632) * x[4]; out[3] = fmaf(t, e[2], out[3]); }
    { const float t = static_cast<float>(-0.40824829046386313) * x[4]; out[2] = fmaf(t, e[3], out[2]); }
    { const float t = static_cast<float>(0.408248290463863) * x[4]; out[0] = fmaf(t, e[5], out[0]); }
    { const float t = static_cast<float>(0.40824829046386274) * x[4]; out[1] = fmaf(t, e[6], out[1]); }
    { const float t = static_cast<float>(0.4082482904638629) * x[5]; out[4] = fmaf(t, e[0], out[4]); }
    { const float t = static_cast<float>(0.4082482904638632) * x[5]; out[3] = fmaf(t, e[1], out[3]); }
    { const float t = static_cast<float>(0.40824829046386296) * x[5]; out[6] = fmaf(t, e[2], out[6]); }
    { const float t = static_cast<float>(-0.4082482904638634) * x[5]; out[1] = fmaf(t, e[3], out[1]); }
    { const float t = static_cast<float>(-0.40824829046386263) * x[5]; out[0] = fmaf(t, e[4], out[0]); }
    { const float t = static_cast<float>(-0.408248290463863) * x[5]; out[2] = fmaf(t, e[6], out[2]); }
    { const float t = static_cast<float>(-0.4082482904638632) * x[6]; out[3] = fmaf(t, e[0], out[3]); }
    { const float t = static_cast<float>(0.4082482904638627) * x[6]; out[4] = fmaf(t, e[1], out[4]); }
    { const float t = static_cast<float>(-0.408248290463863) * x[6]; out[5] = fmaf(t, e[2], out[5]); }
    { const float t = static_cast<float>(0.408248290463863) * x[6]; out[0] = fmaf(t, e[3], out[0]); }
    { const float t = static_cast<float>(-0.40824829046386313) * x[6]; out[1] = fmaf(t, e[4], out[1]); }
    { const float t = static_cast<float>(0.40824829046386296) * x[6]; out[2] = fmaf(t, e[5], out[2]); }
  }
  static __device__ __forceinline__ void bwd(const float (&x)[7], const float (&e)[7], const float (&g)[7],
                                             float (&dx)[7], float (&de)[7]) {
    { const float t = static_cast<float>(0.408248290463863) * g[2]; dx[0] = fmaf(t, e[1], dx[0]); de[1] = fmaf(t, x[0], de[1]); }
    { const float t = static_cast<float>(-0.4082482904638625) * g[1]; dx[0] = fmaf(t, e[2], dx[0]); de[2] = fmaf(t, x[0], de[2]); }
    { const float t = static_cast<float>(-0.40824829046386324) * g[6]; dx[0] = fmaf(t, e[3], dx[0]); de[3] = fmaf(t, x[0], de[3]); }
    { const float t = static_cast<float>(0.40824829046386313) * g[5]; dx[0] = fmaf(t, e[4], dx[0]); de[4] = fmaf(t, x[0], de[4]); }
    { const float t = static_cast<float>(-0.4082482904638645) * g[4]; dx[0] = fmaf(t, e[5], dx[0]); de[5] = fmaf(t, x[0], de[5]); }
    { const float t = static_cast<float>(0.4082482904638634) * g[3]; dx[0] = fmaf(t, e[6], dx[0]); de[6] = fmaf(t, x[0], de[6]); }
    { const float t = static_cast<float>(-0.40824829046386313) * g[2]; dx[1] = fmaf(t, e[0], dx[1]); de[0] = fmaf(t, x[1], de[0]); }
    { const float t = static_cast<float>(0.40824829046386274) * g[0]; dx[1] = fmaf(t, e[2], dx[1]); de[2] = fmaf(t, x[1], de[2]); }
    { const float t = static_cast<float>(0.40824829046386324) * g[5]; dx[1] = fmaf(t, e[3], dx[1]); de[3] = fmaf(t, x[1], de[3]); }
    { const float t = static_cast<float>(0.40824829046386263) * g[6]; dx[1] = fmaf(t, e[4], dx[1]); de[4] = fmaf(t, x[1], de[4]); }
    { const float t = static_cast<float>(-0.4082482904638632) * g[3]; dx[1] = fmaf(t, e[5], dx[1]); de[5] = fmaf(t, x[1], de[5]); }
    { const float t = static_cast<float>(-0.4082482904638627) * g[4]; dx[1] = fmaf(t, e[6], dx[1]); de[6] = fmaf(t, x[1], de[6]); }
    { const float t = static_cast<float>(0.4082482904638629) * g[1]; dx[2] = fmaf(t, e[0], dx[2]); de[0] = fmaf(t, x[2], de[0]); }
    { const float t = static_cast<float>(-0.40824829046386274) * g[0]; dx[2] = fmaf(t, e[1], dx[2]); de[1] = fmaf(t, x[2], de[1]); }
    { const float t = static_cast<float>(0.408248290463863) * g[4]; dx[2] = fmaf(t, e[3], dx[2]); de[3] = fmaf(t, x[2], de[3]); }
    { const float t = static_cast<float>(-0.40824829046386335) * g[3]; dx[2] = fmaf(t, e[4], dx[2]); de[4] = fmaf(t, x[2], de[4]); }
    { const float t = static_cast<float>(-0.40824829046386246) * g[6]; dx[2] = fmaf(t, e[5], dx[2]); de[5] = fmaf(t, x[2], de[5]); }
    { const float t = static_cast<float>(0.4082482904638628) * g[5]; dx[2] = fmaf(t, e[6], dx[2]); de[6] = fmaf(t, x[2], de[6]); }
    { const float t = static_cast<float>(0.40824829046386274) * g[6]; dx[3] = fmaf(t, e[0], dx[3]); de[0] = fmaf(t, x[3], de[0]); }
    { const float t = static_cast<float>(-0.4082482904638634) * g[5]; dx[3] = fmaf(t, e[1], dx[3]); de[1] = fmaf(t, x[3], de[1]); }
    { const float t = static_cast<float>(-0.4082482904638629) * g[4]; dx[3] = fmaf(t, e[2], dx[3]); de[2] = fmaf(t, x[3], de[2]); }
    { const float t = static_cast<float>(0.4082482904638629) * g[2]; dx[3] = fmaf(t, e[4], dx[3]); de[4] = fmaf(t, x[3], de[4]); }
    { const float t = static_cast<float>(0.40824829046386324) * g[1]; dx[3] = fmaf(t, e[5], dx[3]); de[5] = fmaf(t, x[3], de[5]); }
    { const float t = static_cast<float>(-0.408248290463863) * g[0]; dx[3] = fmaf(t, e[6], dx[3]); de[6] = fmaf(t, x[3], de[6]); }
    { const float t = static_cast<float>(-0.40824829046386274) * g[5]; dx[4] = fmaf(t, e[0], dx[4]); de[0] = fmaf(t, x[4], de[0]); }
    { const float t = static_cast<float>(-0.4082482904638628) * g[6]; dx[4] = fmaf(t, e[1], dx[4]); de[1] = fmaf(t, x[4], de[1]); }
    { const float t = static_cast<float>(0.4082482904638632) * g[3]; dx[4] = fmaf(t, e[2], dx[4]); de[2] = fmaf(t, x[4], de[2]); }
    { const float t = static_cast<float>(-0.40824829046386313) * g[2]; dx[4] = fmaf(t, e[3], dx[4]); de[3] = fmaf(t, x[4], de[3]); }
    { const float t = static_cast<float>(0.408248290463863) * g[0]; dx[4] = fmaf(t, e[5], dx[4]); de[5] = fmaf(t, x[4], de[5]); }
    { const float t = static_cast<float>(0.40824829046386274) * g[1]; dx[4] = fmaf(t, e[6], dx[4]); de[6] = fmaf(t, x[4], de[6]); }
    { const float t = static_cast<float>(0.4082482904638629) * g[4]; dx[5] = fmaf(t, e[0], dx[5]); de[0] = fmaf(t, x[5], de[0]); }
    { const float t = static_cast<float>(0.4082482904638632) * g[3]; dx[5] = fmaf(t, e[1], dx[5]); de[1] = fmaf(t, x[5], de[1]); }
    { const float t = static_cast<float>(0.40824829046386296) * g[6]; dx[5] = fmaf(t, e[2], dx[5]); de[2] = fmaf(t, x[5], de[2]); }
    { const float t = static_cast<float>(-0.4082482904638634) * g[1]; dx[5] = fmaf(t, e[3], dx[5]); de[3] = fmaf(t, x[5], de[3]); }
    { const float t = static_cast<float>(-0.40824829046386263) * g[0]; dx[5] = fmaf(t, e[4], dx[5]); de[4] = fmaf(t, x[5], de[4]); }
    { const float t = static_cast<float>(-0.408248290463863) * g[2]; dx[5] = fmaf(t, e[6], dx[5]); de[6] = fmaf(t, x[5], de[6]); }
    { const float t = static_cast<float>(-0.4082482904638632) * g[3]; dx[6] = fmaf(t, e[0], dx[6]); de[0] = fmaf(t, x[6], de[0]); }
    { const float t = static_cast<float>(0.4082482904638627) * g[4]; dx[6] = fmaf(t, e[1], dx[6]); de[1] = fmaf(t, x[6], de[1]); }
    { const float t = static_cast<float>(-0.408248290463863) * g[5]; dx[6] = fmaf(t, e[2], dx[6]); de[2] = fmaf(t, x[6], de[2]); }
    { const float t = static_cast<float>(0.408248290463863) * g[0]; dx[6] = fmaf(t, e[3], dx[6]); de[3] = fmaf(t, x[6], de[3]); }
    { const float t = static_cast<float>(-0.40824829046386313) * g[1]; dx[6] = fmaf(t, e[4], dx[6]); de[4] = fmaf(t, x[6], de[4]); }
    { const float t = static_cast<float>(0.40824829046386296) * g[2]; dx[6] = fmaf(t, e[5], dx[6]); de[5] = fmaf(t, x[6], de[5]); }
  }
};

template <typename F>
__device__ __forceinline__ bool cg_dispatch(int tid, F& f) {
  switch (tid) {
    case 0: f.template run<0, 0, 0>(); return true;
    case 1: f.template run<0, 1, 1>(); return true;
    case 2: f.template run<0, 2, 2>(); return true;
    case 3: f.template run<0, 3, 3>(); return true;
    case 4: f.template run<1, 0, 1>(); return true;
    case 5: f.template run<1, 1, 0>(); return true;
    case 6: f.template run<1, 1, 1>(); return true;
    case 7: f.template run<1, 1, 2>(); return true;
    case 8: f.template run<1, 2, 1>(); return true;
    case 9: f.template run<1, 2, 2>(); return true;
    case 10: f.template run<1, 2, 3>(); return true;
    case 11: f.template run<1, 3, 2>(); return true;
    case 12: f.template run<1, 3, 3>(); return true;
    case 13: f.template run<2, 0, 2>(); return true;
    case 14: f.template run<2, 1, 1>(); return true;
    case 15: f.template run<2, 1, 2>(); return true;
    case 16: f.template run<2, 1, 3>(); return true;
    case 17: f.template run<2, 2, 0>(); return true;
    case 18: f.template run<2, 2, 1>(); return true;
    case 19: f.template run<2, 2, 2>(); return true;
    case 20: f.template run<2, 2, 3>(); return true;
    case 21: f.template run<2, 3, 1>(); return true;
    case 22: f.template run<2, 3, 2>(); return true;
    case 23: f.template run<2, 3, 3>(); return true;
    case 24: f.template run<3, 0, 3>(); return true;
    case 25: f.template run<3, 1, 2>(); return true;
    case 26: f.template run<3, 1, 3>(); return true;
    case 27: f.template run<3, 2, 1>(); return true;
    case 28: f.template run<3, 2, 2>(); return true;
    case 29: f.template run<3, 2, 3>(); return true;
    case 30: f.template run<3, 3, 0>(); return true;
    case 31: f.template run<3, 3, 1>(); return true;
    case 32: f.template run<3, 3, 2>(); return true;
    case 33: f.template run<3, 3, 3>(); return true;
    default: return false;
  }
}

}  // namespace
