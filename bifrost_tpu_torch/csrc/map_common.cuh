// The run-time support of bf.map's generated kernels (kernel M1).
//
// ops/map_codegen.py turns one user expression of the map mini-language
// into a CUDA C++ source that includes this header: a complex type, the
// operators on it, the loads of every storage form a stream arrives in,
// and the math functions with the semantics of the port's plain engine
// (PyTorch's operators, which for these functions are JAX's):
//
// - `/` on integers is true division (the operands become float first,
//   the code generator casts them); `//` and `%` floor, as Python does;
// - integer +, -, *, negation and powers wrap (computed unsigned);
// - round and rint round half to even (rint), as jnp.round does;
// - mmin/mmax propagate a NaN, as jnp.minimum/maximum and
//   torch.minimum/maximum do (C's fminf does not);
// - rsqrt is 1/sqrt, not the approximate rsqrtf;
// - the complex product is (ac - bd, ad + bc) and the quotient follows
//   c10::complex's (numpy's) scaled algorithm;
// - cvt<T> follows astype / Tensor.to: a complex value cast to a real
//   type keeps its real part, a real value cast to complex gets a zero
//   imaginary part, a float cast to an integer truncates.
//
// - f16 and bf16 are storage types: every operator converts its
//   operands to f32, computes there and rounds the result back to the
//   storage type (round to nearest even), as PyTorch's kernels do with
//   their f32 "opmath"; a Python scalar that PyTorch's card kernels read
//   straight into f32 (+, -, * with a CPU scalar) is passed to the f32
//   operator unrounded by the generator;
// - the complex transcendentals (log, log2, log10, sin, cos, tan, asin,
//   acos, atan, sinh, cosh, tanh, pow, rsqrt's square root, and sqrt of
//   complex128) are computed in f64 and rounded to the component type,
//   with the formulas named at each; sqrt of complex64 is computed in f32
//   (`csqrt_f`: Kahan's algorithm, scaled by powers of two).  Within
//   a few ulps of |z| (or of the result where it is larger) of PyTorch's
//   c10::complex / thrust kernels away from the branch cuts.
//
// Every function is __host__ __device__, so a generated source also
// compiles with the host C++ compiler: the CPU tests run the generated
// statement bodies against the plain engine with no card.  Kernels are
// built with --fmad=false (and the host build with -ffp-contract=off),
// so no multiply and add are contracted: the plain engine rounds each
// operator on its own.
//
// Index arithmetic (the generated kernel is instantiated for a 32-bit and
// a 64-bit index type, `I`): no division by a run-time extent; `div_magic`
// divides by a host-computed multiply-and-shift pair (ops/map_kernel.py
// `magic`, PyTorch's IntDivider method: q = (umulhi(n, m) + n) >> s,
// exact for every n of the index type's non-negative range).  Vector
// access: `vld_words` / `vst_words` move NB bytes as 16-, 8-, 4-, 2- or
// 1-byte words (`memcpy` on the host) and the `vl_*` / `vs` helpers
// unpack and pack the storage forms in registers.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

// A generated source that uses f16 or bf16 defines MAP_HALF_TYPES first:
// the card's conversion instructions come from CUDA's half headers, which
// cost every other kernel's build a second.
#if defined(__CUDACC__) && defined(MAP_HALF_TYPES)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#define MAP_HALF_INTRINSICS 1
#endif

#ifdef __CUDACC__
#define MAP_HD __host__ __device__ __forceinline__
#else
#define MAP_HD inline
#endif

namespace bfmap {

// ------------------------------------------------- half storage types
MAP_HD uint32_t f32_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
MAP_HD float bits_f32(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// f32 -> f16 bits, round to nearest even; a NaN becomes the quiet NaN
// 0x7e00 with its sign (c10::Half's host conversion).
MAP_HD uint16_t f16_from_f32(float f) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __half_as_ushort(__float2half_rn(f));
#else
  const uint32_t x = f32_bits(f);
  const uint32_t sign = (x >> 16) & 0x8000u;
  const uint32_t ax = x & 0x7fffffffu;
  if (ax > 0x7f800000u) return static_cast<uint16_t>(sign | 0x7e00u);
  if (ax >= 0x477ff000u) return static_cast<uint16_t>(sign | 0x7c00u);
  if (ax >= 0x38800000u) {              // a normal half
    const uint32_t r = ax - 0x38000000u;
    return static_cast<uint16_t>(
        sign | ((r + 0xfffu + ((r >> 13) & 1u)) >> 13));
  }
  // below 2**-14: a multiple of 2**-24, rounded to nearest even (v and
  // its fraction are exact in f32)
  const float v = bits_f32(ax) * 16777216.0f;
  uint32_t m = static_cast<uint32_t>(v);
  const float frac = v - static_cast<float>(m);
  if (frac > 0.5f || (frac == 0.5f && (m & 1u))) ++m;
  return static_cast<uint16_t>(sign | m);
#endif
}
MAP_HD float f16_to_f32(uint16_t h) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __half2float(__ushort_as_half(h));
#else
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1fu, m = h & 0x3ffu;
  if (e == 0x1f) return bits_f32(sign | 0x7f800000u | (m << 13));
  if (e) return bits_f32(sign | ((e + 112u) << 23) | (m << 13));
  const float v = static_cast<float>(m) * 5.9604644775390625e-8f;
  return sign ? -v : v;
#endif
}
// f32 -> bf16 bits, round to nearest even; a NaN becomes 0x7fc0
// (c10::BFloat16's host conversion).
MAP_HD uint16_t bf16_from_f32(float f) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
#else
  const uint32_t x = f32_bits(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((x + 0x7fffu + ((x >> 16) & 1u)) >> 16);
#endif
}
MAP_HD float bf16_to_f32(uint16_t h) {
  return bits_f32(static_cast<uint32_t>(h) << 16);
}

// A 16-bit float in storage: constructed from an f32 (rounded), read as
// an f32 (exact).  Its operators round each result, as c10::Half's do.
template <int KIND>  // 0 f16, 1 bf16
struct half_t {
  uint16_t bits;
  MAP_HD half_t() : bits(0) {}
  MAP_HD explicit half_t(float v)
      : bits(KIND == 0 ? f16_from_f32(v) : bf16_from_f32(v)) {}
  MAP_HD operator float() const {
    return KIND == 0 ? f16_to_f32(bits) : bf16_to_f32(bits);
  }
};
using f16 = half_t<0>;
using bf16 = half_t<1>;

template <int K>
MAP_HD half_t<K> operator+(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) + float(b));
}
template <int K>
MAP_HD half_t<K> operator-(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) - float(b));
}
template <int K>
MAP_HD half_t<K> operator*(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) * float(b));
}
template <int K>
MAP_HD half_t<K> operator/(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) / float(b));
}
template <int K>
MAP_HD half_t<K> operator-(half_t<K> a) {
  half_t<K> r;
  r.bits = static_cast<uint16_t>(a.bits ^ 0x8000u);
  return r;
}

template <typename T> struct is_half : std::false_type {};
template <int K> struct is_half<half_t<K>> : std::true_type {};
// Floating point, the storage halves included.
template <typename T>
struct is_fp : std::integral_constant<bool, std::is_floating_point<T>::value ||
                                                is_half<T>::value> {};

// Aligned to its size, so a complex value is one 8-byte (complex64) or
// 16-byte (complex128) access.
template <typename T>
struct alignas(2 * sizeof(T)) cx {
  T re, im;
  MAP_HD cx() : re(0), im(0) {}
  MAP_HD cx(T r, T i) : re(r), im(i) {}
};

template <typename T> struct is_cx : std::false_type {};
template <typename T> struct is_cx<cx<T>> : std::true_type {};
template <typename T> struct comp { using type = T; };
template <typename T> struct comp<cx<T>> { using type = T; };

// ------------------------------------------------------------- casts
template <typename To, typename From>
MAP_HD To cvt(From v) {
  if constexpr (is_cx<To>::value) {
    using C = typename comp<To>::type;
    if constexpr (is_cx<From>::value) {
      return To(static_cast<C>(v.re), static_cast<C>(v.im));
    } else {
      return To(static_cast<C>(v), C(0));
    }
  } else if constexpr (std::is_same<To, bool>::value) {
    if constexpr (is_cx<From>::value) {
      return v.re != 0 || v.im != 0;
    } else {
      return v != 0;
    }
  } else if constexpr (is_cx<From>::value) {
    return static_cast<To>(v.re);
  } else {
    return static_cast<To>(v);
  }
}

template <typename T>
MAP_HD bool truth(T v) { return cvt<bool>(v); }

// Integer arithmetic that wraps: computed on the unsigned type of the
// same width, then converted back (two's complement).
template <typename T>
using uns = typename std::make_unsigned<
    typename std::conditional<std::is_same<T, bool>::value, uint8_t,
                              T>::type>::type;

// ----------------------------------------------------- the operators
template <typename T>
MAP_HD T op_add(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) + float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re + b.re, a.im + b.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) + static_cast<uns<T>>(b)));
  } else {
    return a + b;
  }
}

template <typename T>
MAP_HD T op_sub(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) - float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re - b.re, a.im - b.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) - static_cast<uns<T>>(b)));
  } else {
    return a - b;
  }
}

template <typename T>
MAP_HD T op_mul(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) * float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) * static_cast<uns<T>>(b)));
  } else {
    return a * b;
  }
}

template <typename T>
MAP_HD T op_neg(T a) {
  if constexpr (is_half<T>::value) {
    return -a;
  } else if constexpr (is_cx<T>::value) {
    return T(-a.re, -a.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        uns<T>(0) - static_cast<uns<T>>(a)));
  } else {
    return -a;
  }
}

// True division (floats and complex; the generator makes integer
// operands float first).  The complex quotient is c10::complex's.
template <typename T>
MAP_HD T op_div(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) / float(b));
  } else if constexpr (is_cx<T>::value) {
    using C = typename comp<T>::type;
    C ar = a.re, ai = a.im, c = b.re, d = b.im;
    C abs_c = c < 0 ? -c : c;
    C abs_d = d < 0 ? -d : d;
    if (abs_c >= abs_d) {
      if (abs_c == C(0) && abs_d == C(0)) {
        return T(ar / abs_c, ai / abs_d);
      }
      C rat = d / c;
      C scl = C(1.0) / (c + d * rat);
      return T((ar + ai * rat) * scl, (ai - ar * rat) * scl);
    }
    C rat = c / d;
    C scl = C(1.0) / (d + c * rat);
    return T((ar * rat + ai) * scl, (ai * rat - ar) * scl);
  } else {
    return a / b;
  }
}

// Floor division: Python's and torch.floor_divide's.
template <typename T>
MAP_HD T op_floordiv(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(op_floordiv<float>(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    if ((a < 0) != (b < 0)) {
      T q = static_cast<T>(a / b);
      T r = static_cast<T>(a % b);
      return r ? static_cast<T>(q - 1) : q;
    }
    return static_cast<T>(a / b);
  } else {
    if (b == T(0)) return a / b;
    T mod = std::fmod(a, b);
    T div = (a - mod) / b;
    if ((mod != 0) && ((b < 0) != (mod < 0))) div -= T(1);
    T fl;
    if (div != 0) {
      fl = std::floor(div);
      if (div - fl > T(0.5)) fl += T(1.0);
    } else {
      fl = std::copysign(T(0), a / b);
    }
    return fl;
  }
}

// Floor modulo: the result takes the divisor's sign.
template <typename T>
MAP_HD T op_mod(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(op_mod<float>(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    T m = static_cast<T>(a % b);
    if ((m != 0) && ((b < 0) != (m < 0))) m = static_cast<T>(m + b);
    return m;
  } else {
    T m = std::fmod(a, b);
    if ((m != 0) && ((b < 0) != (m < 0))) m += b;
    return m;
  }
}

// Integer power by squaring, wrapping; a negative exponent gives what
// torch's integer pow gives (1 for a base of 1, +-1 for -1, else 0).
template <typename T, typename E>
MAP_HD T powi(T a, E b) {
  if (b < 0) {
    if (a == 1) return T(1);
    if (a == -1) return (b % 2 == 0) ? T(1) : T(-1);
    return T(0);
  }
  T r = 1;
  while (b) {
    if (b & 1) r = op_mul<T>(r, a);
    b /= 2;
    a = op_mul<T>(a, a);
  }
  return r;
}

template <typename T>
MAP_HD T op_pow(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(std::pow(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    return powi<T, T>(a, b);
  } else {
    return std::pow(a, b);
  }
}

template <typename T>
MAP_HD T op_and(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a && b;
  else return static_cast<T>(a & b);
}
template <typename T>
MAP_HD T op_or(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a || b;
  else return static_cast<T>(a | b);
}
template <typename T>
MAP_HD T op_xor(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a != b;
  else return static_cast<T>(a ^ b);
}
// Shifts as PyTorch's: a shift by a negative amount or by the width or
// more gives 0 to the left and the sign fill to the right; a left shift
// wraps (computed on the unsigned type).
template <typename T>
MAP_HD T op_shl(T a, T b) {
  if (b < 0 || b >= T(8 * sizeof(T))) return T(0);
  return static_cast<T>(static_cast<uns<T>>(static_cast<uns<T>>(a)
                                            << static_cast<int>(b)));
}
template <typename T>
MAP_HD T op_shr(T a, T b) {
  if (b < 0 || b >= T(8 * sizeof(T))) return a < 0 ? T(-1) : T(0);
  return static_cast<T>(a >> static_cast<int>(b));
}
template <typename T>
MAP_HD T op_invert(T a) {
  if constexpr (std::is_same<T, bool>::value) return !a;
  else return static_cast<T>(~a);
}

template <typename T>
MAP_HD bool op_eq(T a, T b) {
  if constexpr (is_cx<T>::value) return a.re == b.re && a.im == b.im;
  else return a == b;
}
template <typename T>
MAP_HD bool op_ne(T a, T b) { return !op_eq<T>(a, b); }

// -------------------------------------------------- the math functions
template <typename T>
MAP_HD T mmin(T a, T b) {
  if constexpr (is_fp<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a < b ? a : b;
}
template <typename T>
MAP_HD T mmax(T a, T b) {
  if constexpr (is_fp<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a > b ? a : b;
}

template <typename T>
MAP_HD T mabs(T a) {
  if constexpr (is_half<T>::value) {
    T r;
    r.bits = static_cast<uint16_t>(a.bits & 0x7fffu);
    return r;
  } else if constexpr (std::is_integral<T>::value) {
    return a < 0 ? op_neg<T>(a) : a;
  } else {
    return std::fabs(a);
  }
}
template <typename C>
MAP_HD C mabs(cx<C> a) { return std::hypot(a.re, a.im); }

template <typename T> MAP_HD T mfloor(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::floor(float(a)));
  else return std::floor(a);
}
template <typename T> MAP_HD T mceil(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::ceil(float(a)));
  else return std::ceil(a);
}
// Half to even, as jnp.round and torch.round.
template <typename T> MAP_HD T mrint(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::rint(float(a)));
  else return std::rint(a);
}
template <typename T> MAP_HD T msqrt(T a) {
  if constexpr (is_half<T>::value) return T(std::sqrt(float(a)));
  else return std::sqrt(a);
}
// 1/sqrt: the square root rounded to T first, as the plain engine
// divides 1 by torch.sqrt's result.
template <typename T> MAP_HD T mrsqrt(T a) {
  if constexpr (is_half<T>::value) return T(1.0f / float(msqrt<T>(a)));
  else return T(1) / std::sqrt(a);
}

template <typename C>
MAP_HD cx<C> mexp(cx<C> a) {
  C m = std::exp(a.re);
  return cx<C>(m * std::cos(a.im), m * std::sin(a.im));
}
template <typename T> MAP_HD T mexp(T a) { return std::exp(a); }

// --------------------------------------------- complex transcendentals
// Each is computed on cx<double> and rounded to the component type.
using cxd = cx<double>;

template <typename C>
MAP_HD cx<C> cx_round(cxd a) {
  return cx<C>(static_cast<C>(a.re), static_cast<C>(a.im));
}
template <typename C>
MAP_HD cxd cx_wide(cx<C> a) { return cxd(a.re, a.im); }

// Principal square root (Kahan): no cancellation on either half-plane.
MAP_HD cxd csqrt_d(cxd z) {
  const double x = z.re, y = z.im;
  if (x == 0 && y == 0) return cxd(0.0, y);
  if (std::isinf(y)) return cxd(INFINITY, y);
  const double t = std::sqrt((std::fabs(x) + std::hypot(x, y)) * 0.5);
  if (x >= 0) return cxd(t, y / (2 * t));
  return cxd(std::fabs(y) / (2 * t), std::copysign(t, y));
}
MAP_HD cxd clog_d(cxd z) {
  return cxd(std::log(std::hypot(z.re, z.im)), std::atan2(z.im, z.re));
}
// log(1 + d) for small d without the cancellation of 1 + d.
MAP_HD cxd clog1p_d(cxd d) {
  return cxd(0.5 * std::log1p(2 * d.re + (d.re * d.re + d.im * d.im)),
             std::atan2(d.im, 1 + d.re));
}
MAP_HD cxd cexp_d(cxd z) {
  const double m = std::exp(z.re);
  return cxd(m * std::cos(z.im), m * std::sin(z.im));
}
MAP_HD cxd csinh_d(cxd z) {
  return cxd(std::sinh(z.re) * std::cos(z.im),
             std::cosh(z.re) * std::sin(z.im));
}
MAP_HD cxd ccosh_d(cxd z) {
  return cxd(std::cosh(z.re) * std::cos(z.im),
             std::sinh(z.re) * std::sin(z.im));
}
// tanh (Kahan's formula; the large-|x| limit where it would overflow).
MAP_HD cxd ctanh_d(cxd z) {
  const double x = z.re, y = z.im;
  if (std::fabs(x) > 22) {
    const double e = std::exp(-std::fabs(x));
    return cxd(std::copysign(1.0, x), 4 * std::sin(y) * std::cos(y) * e * e);
  }
  const double t = std::tan(y), b = 1 + t * t, s = std::sinh(x);
  const double r = std::sqrt(1 + s * s), d = 1 + b * s * s;
  return cxd(b * r * s / d, t / d);
}
// asinh(w) = log(w + sqrt(w^2 + 1)) on Re w >= 0 (odd otherwise), as
// log1p(w + w^2 / (sqrt(w^2 + 1) + 1)) so a small w keeps its digits.
MAP_HD cxd casinh_d(cxd w) {
  if (std::signbit(w.re)) {
    const cxd r = casinh_d(cxd(-w.re, -w.im));
    return cxd(-r.re, -r.im);
  }
  const cxd w2(w.re * w.re - w.im * w.im, 2 * w.re * w.im);
  const cxd s = csqrt_d(cxd(w2.re + 1, w2.im));
  const cxd q = op_div<cxd>(w2, cxd(s.re + 1, s.im));
  return clog1p_d(cxd(w.re + q.re, w.im + q.im));
}
// s = a + b and its rounding error e (Knuth's TwoSum).
MAP_HD double two_sum(double a, double b, double& e) {
  const double s = a + b, bb = s - a;
  e = (a - (s - bb)) + (b - bb);
  return s;
}
// atanh(w) = (log(1 + w) - log(1 - w)) / 2, in the forms without
// cancellation: Re = log1p(4u / ((1 - u)^2 + v^2)) / 4,
// Im = atan2(2v, 1 - u^2 - v^2) / 2, 1 - u^2 - v^2 summed from the
// exact squares (fma) so it keeps its digits near |w| = 1; on Re w >= 0
// (odd otherwise), where the log1p argument is not near -1.
MAP_HD cxd catanh_d(cxd w) {
  if (std::signbit(w.re)) {
    const cxd r = catanh_d(cxd(-w.re, -w.im));
    return cxd(-r.re, -r.im);
  }
  const double u = w.re, v = w.im, a = 1 - u;
  const double uh = u * u, ul = std::fma(u, u, -uh);
  const double vh = v * v, vl = std::fma(v, v, -vh);
  double e1, e2;
  const double s1 = two_sum(1.0, -uh, e1);
  const double s2 = two_sum(s1, -vh, e2);
  const double d = s2 + (((e1 + e2) - ul) - vl);
  return cxd(0.25 * std::log1p(4 * u / (a * a + v * v)),
             0.5 * std::atan2(2 * v, d));
}

// complex64 sqrt in f32: Kahan's algorithm as thrust's csqrtf arranges
// it (Algorithm 312, CACM 10, 1967), |z| as sqrt(a*a + b*b) with the
// operands scaled by an even power of two so that the squares stay
// normal and finite: by 2^-66 when max(|a|, |b|) >= 2^60 (the parts
// then lie in [2^-6, 2^62], the sum of squares below 2^125), by 2^100
// when it is below 2^-60 (a subnormal part becomes at least 2^-49,
// exactly, its square at least 2^-98); the root is scaled back by the
// square root of the factor (within 2 ulps of max(|z|, |w|) of the true
// value; hypot would cost some twenty instructions more a sample).
MAP_HD cx<float> csqrt_f(cx<float> z) {
  float a = z.re, b = z.im;
  if (a == 0.0f && b == 0.0f) return cx<float>(0.0f, b);
  if (std::isinf(b)) return cx<float>(INFINITY, b);
  if (std::isnan(a)) return cx<float>(a, (b - b) / (b - b));
  if (std::isinf(a)) {
    if (std::signbit(a)) return cx<float>(std::fabs(b - b), std::copysign(a, b));
    return cx<float>(a, std::copysign(b - b, b));
  }
  const float big = std::fabs(a) > std::fabs(b) ? std::fabs(a) : std::fabs(b);
  float back = 1.0f;
  if (big >= 0x1p+60f) {
    a *= 0x1p-66f;
    b *= 0x1p-66f;
    back = 0x1p+33f;
  } else if (big < 0x1p-60f) {
    a *= 0x1p+100f;
    b *= 0x1p+100f;
    back = 0x1p-50f;
  }
  const float h = std::sqrt(a * a + b * b);
  cx<float> r;
  if (a >= 0) {
    const float t = std::sqrt((a + h) * 0.5f);
    r = cx<float>(t, b / (2.0f * t));
  } else {
    const float t = std::sqrt((-a + h) * 0.5f);
    r = cx<float>(std::fabs(b) / (2.0f * t), std::copysign(t, b));
  }
  return cx<float>(r.re * back, r.im * back);
}

template <typename C>
MAP_HD cx<C> msqrt(cx<C> a) {
  if constexpr (std::is_same<C, float>::value) return csqrt_f(a);
  else return cx_round<C>(csqrt_d(cx_wide(a)));
}
template <typename C>
MAP_HD cx<C> mlog(cx<C> a) { return cx_round<C>(clog_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mlog2(cx<C> a) {
  const cxd l = clog_d(cx_wide(a));
  const double k = 1.4426950408889634;          // 1 / log(2)
  return cx_round<C>(cxd(l.re * k, l.im * k));
}
template <typename C>
MAP_HD cx<C> mlog10(cx<C> a) {
  const cxd l = clog_d(cx_wide(a));
  const double k = 0.43429448190325176;         // 1 / log(10)
  return cx_round<C>(cxd(l.re * k, l.im * k));
}
template <typename C>
MAP_HD cx<C> msinh(cx<C> a) { return cx_round<C>(csinh_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mcosh(cx<C> a) { return cx_round<C>(ccosh_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mtanh(cx<C> a) { return cx_round<C>(ctanh_d(cx_wide(a))); }
// sin z = -i sinh(iz), cos z = cosh(iz), tan z = -i tanh(iz).
template <typename C>
MAP_HD cx<C> msin(cx<C> a) {
  const cxd r = csinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
template <typename C>
MAP_HD cx<C> mcos(cx<C> a) {
  return cx_round<C>(ccosh_d(cxd(-double(a.im), a.re)));
}
template <typename C>
MAP_HD cx<C> mtan(cx<C> a) {
  const cxd r = ctanh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
// asin z = -i asinh(iz), acos z = pi/2 - asin z, atan z = -i atanh(iz).
template <typename C>
MAP_HD cx<C> masin(cx<C> a) {
  const cxd r = casinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
template <typename C>
MAP_HD cx<C> macos(cx<C> a) {
  const cxd r = casinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(1.5707963267948966 - r.im, r.re));
}
template <typename C>
MAP_HD cx<C> matan(cx<C> a) {
  const cxd r = catanh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
// 1 / sqrt: c10's quotient of 1 by the square root rounded from f64 (for
// complex64 too: over the f32 sqrt the quotient reads 2.04-2.53 ulps of a
// 120-bit reference, above the 2 ulps the CPU tests hold complex64
// bodies to).
template <typename C>
MAP_HD cx<C> mrsqrt(cx<C> a) {
  return op_div<cx<C>>(cx<C>(C(1), C(0)), cx_round<C>(csqrt_d(cx_wide(a))));
}
// z ** w = exp(w log z), as thrust::pow.
template <typename C>
MAP_HD cx<C> mpow(cx<C> z, cx<C> w) {
  const cxd l = clog_d(cx_wide(z)), e = cx_wide(w);
  return cx_round<C>(cexp_d(cxd(e.re * l.re - e.im * l.im,
                                e.re * l.im + e.im * l.re)));
}

template <typename C>
MAP_HD cx<C> mconj(cx<C> a) { return cx<C>(a.re, -a.im); }
template <typename C>
MAP_HD C mmag2(cx<C> a) { return a.re * a.re + a.im * a.im; }

// ------------------------------------------------------ index arithmetic
MAP_HD uint32_t umulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}
MAP_HD uint64_t umulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return static_cast<uint64_t>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}
// n / d for 0 <= n <= the index type's maximum, by the magic word `m` and
// shift `s` the host computed for d (a d of 1 has m 1, s 0).
template <typename I>
MAP_HD I div_magic(I n, long long m, long long s) {
  if constexpr (sizeof(I) == 4) {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<I>((umulhi32(u, static_cast<uint32_t>(m)) + u) >>
                          static_cast<int>(s));
  } else {
    const uint64_t u = static_cast<uint64_t>(n);
    return static_cast<I>((umulhi64(u, static_cast<uint64_t>(m)) + u) >>
                          static_cast<int>(s));
  }
}

// A gather index as jnp indexing takes it: a negative index wraps once,
// then the index is clamped to the axis (computed in the index
// expression's own type, returned as the kernel's index type).
template <typename I, typename T>
MAP_HD I wrapclamp(T i, I n) {
  using W = decltype(i + n);
  W w = static_cast<W>(i);
  if (w < 0) w += static_cast<W>(n);
  return static_cast<I>(w < 0 ? W(0) : (w >= static_cast<W>(n)
                                        ? static_cast<W>(n) - 1 : w));
}

// A scatter index as jnp's .at[idx].set takes it: a negative index wraps
// once; an index still outside the axis drops the update (`ok` false).
template <typename I, typename T>
MAP_HD I wrapdrop(T i, I n, bool& ok) {
  using W = decltype(i + n);
  W w = static_cast<W>(i);
  if (w < 0) w += static_cast<W>(n);
  if (w < 0 || w >= static_cast<W>(n)) {
    ok = false;
    return I(0);
  }
  return static_cast<I>(w);
}

// A scatter's owner word: the largest (source position + 1) that targets
// it, so that of repeated targets the highest source position wins.
template <typename OW>
MAP_HD void owner_max(OW* p, OW v) {
#ifdef __CUDA_ARCH__
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}

// ----------------------------------------------- loads by storage form
template <typename T, typename O>
MAP_HD T ld_real(const void* p, O off) {
  return static_cast<const T*>(p)[off];
}
// A complex tensor: (re, im) pairs of its component type, one access.
template <typename C, typename O>
MAP_HD cx<C> ld_cx(const void* p, O off) {
  return static_cast<const cx<C>*>(p)[off];
}
// Complex-integer ring storage (ci8, ci16, ci32): the integer component
// type with a trailing (re, im) axis, `cs` elements between the two.
template <typename C, typename I, typename O, typename S>
MAP_HD cx<C> ld_pair(const void* p, O off, S cs) {
  const I* q = static_cast<const I*>(p) + off;
  return cx<C>(static_cast<C>(q[0]), static_cast<C>(q[cs]));
}
// Packed ci4: one sample a byte, the real part in the high nibble
// (MSB first), each nibble sign-extended (ops/unpack.py).
template <typename C>
MAP_HD cx<C> ci4_of(uint32_t b) {
  const int re = static_cast<int8_t>(static_cast<uint8_t>(b & 0xF0u)) >> 4;
  const int im = static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
  return cx<C>(static_cast<C>(re), static_cast<C>(im));
}
// Packed ci2 and ci1: 8 / (2 NBIT) samples a byte along the last axis,
// each (re, im) pair of fields MSB first and sign-extended (the field
// order of ops/unpack.py); `pos` the sample in the byte.
template <typename C, int NBIT>
MAP_HD cx<C> cpacked_of(uint32_t b, int pos) {
  constexpr int PER = 8 / NBIT;
  const int sh = 8 - NBIT;
  const uint8_t fr = static_cast<uint8_t>(b >> ((PER - 1 - 2 * pos) * NBIT));
  const uint8_t fi = static_cast<uint8_t>(b >> ((PER - 2 - 2 * pos) * NBIT));
  const int re = static_cast<int8_t>(static_cast<uint8_t>(fr << sh)) >> sh;
  const int im = static_cast<int8_t>(static_cast<uint8_t>(fi << sh)) >> sh;
  return cx<C>(static_cast<C>(re), static_cast<C>(im));
}
// Packed real storage (i4/u4, i2/u2, i1/u1): 8 / NBIT samples a byte
// along the last axis, MSB first; a signed field is sign-extended by
// the shifts of ops/unpack.py.  `pos` the field in the byte.
template <typename T, int NBIT>
MAP_HD T packed_of(uint32_t b, int pos) {
  constexpr int PER = 8 / NBIT;
  const uint8_t v = static_cast<uint8_t>(
      (b >> ((PER - 1 - pos) * NBIT)) & ((1u << NBIT) - 1));
  if constexpr (std::is_signed<T>::value) {
    return static_cast<T>(
        static_cast<int8_t>(static_cast<uint8_t>(v << (8 - NBIT))) >>
        (8 - NBIT));
  } else {
    return static_cast<T>(v);
  }
}
template <typename C, typename O>
MAP_HD cx<C> ld_ci4(const void* p, O off) {
  return ci4_of<C>(static_cast<const uint8_t*>(p)[off]);
}
// `off` is the byte, `pos` the sample in it (a shift and a mask of the
// logical index: PER is a power of two).
template <typename C, int NBIT, typename O>
MAP_HD cx<C> ld_cpacked(const void* p, O off, int pos) {
  return cpacked_of<C, NBIT>(static_cast<const uint8_t*>(p)[off], pos);
}
template <typename T, int NBIT, typename O>
MAP_HD T ld_packed(const void* p, O off, int pos) {
  return packed_of<T, NBIT>(static_cast<const uint8_t*>(p)[off], pos);
}

template <typename T, typename O>
MAP_HD void st(void* p, O off, T v) {
  static_cast<T*>(p)[off] = v;
}

// --------------------------------------------------------- vector access
// NB bytes at `q` (aligned to min(NB, 16)) to and from 32-bit words (a
// whole number of them, or one word holding 1 or 2 bytes).
#ifdef __CUDACC__
using w16_t = uint4;
using w8_t = uint2;
#else
struct alignas(16) w16_t { uint32_t x, y, z, w; };
struct alignas(8) w8_t { uint32_t x, y; };
#endif

template <int NB>
MAP_HD void vld_words(uint32_t* wd, const void* q) {
  if constexpr (NB >= 16) {
    static_assert(NB % 16 == 0, "vector of a whole number of 16 bytes");
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
#ifdef __CUDA_ARCH__
      const w16_t v = static_cast<const w16_t*>(q)[k];
#else
      w16_t v;
      std::memcpy(&v, static_cast<const char*>(q) + 16 * k, 16);
#endif
      wd[4 * k] = v.x;
      wd[4 * k + 1] = v.y;
      wd[4 * k + 2] = v.z;
      wd[4 * k + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
#ifdef __CUDA_ARCH__
    const w8_t v = *static_cast<const w8_t*>(q);
#else
    w8_t v;
    std::memcpy(&v, q, 8);
#endif
    wd[0] = v.x;
    wd[1] = v.y;
  } else if constexpr (NB == 4) {
    wd[0] = *static_cast<const uint32_t*>(q);
  } else if constexpr (NB == 2) {
    wd[0] = *static_cast<const uint16_t*>(q);
  } else {
    static_assert(NB == 1, "vector of 1, 2, 4, 8 or 16k bytes");
    wd[0] = *static_cast<const uint8_t*>(q);
  }
}

template <int NB>
MAP_HD void vst_words(void* q, const uint32_t* wd) {
  if constexpr (NB >= 16) {
    static_assert(NB % 16 == 0, "vector of a whole number of 16 bytes");
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
      w16_t v;
      v.x = wd[4 * k];
      v.y = wd[4 * k + 1];
      v.z = wd[4 * k + 2];
      v.w = wd[4 * k + 3];
#ifdef __CUDA_ARCH__
      // the streaming hint: an output is not read again by the kernel
      __stcs(static_cast<w16_t*>(q) + k, v);
#else
      std::memcpy(static_cast<char*>(q) + 16 * k, &v, 16);
#endif
    }
  } else if constexpr (NB == 8) {
    w8_t v;
    v.x = wd[0];
    v.y = wd[1];
#ifdef __CUDA_ARCH__
    *static_cast<w8_t*>(q) = v;
#else
    std::memcpy(q, &v, 8);
#endif
  } else if constexpr (NB == 4) {
    *static_cast<uint32_t*>(q) = wd[0];
  } else if constexpr (NB == 2) {
    *static_cast<uint16_t*>(q) = static_cast<uint16_t>(wd[0]);
  } else {
    static_assert(NB == 1, "vector of 1, 2, 4, 8 or 16k bytes");
    *static_cast<uint8_t*>(q) = static_cast<uint8_t>(wd[0]);
  }
}

// Slot k of SZ bytes in the words (little-endian, as on the card and the
// host); the indices are constants once the vector loops unroll.
template <int SZ>
MAP_HD uint64_t slot(const uint32_t* wd, int k) {
  if constexpr (SZ == 1) return (wd[k >> 2] >> (8 * (k & 3))) & 0xffu;
  else if constexpr (SZ == 2) return (wd[k >> 1] >> (16 * (k & 1))) & 0xffffu;
  else if constexpr (SZ == 4) return wd[k];
  else return wd[2 * k] | (static_cast<uint64_t>(wd[2 * k + 1]) << 32);
}
template <int SZ>
MAP_HD void put_slot(uint32_t* wd, int k, uint64_t u) {
  if constexpr (SZ == 1) wd[k >> 2] |= static_cast<uint32_t>(u) << (8 * (k & 3));
  else if constexpr (SZ == 2) wd[k >> 1] |= static_cast<uint32_t>(u) << (16 * (k & 1));
  else if constexpr (SZ == 4) wd[k] = static_cast<uint32_t>(u);
  else {
    wd[2 * k] = static_cast<uint32_t>(u);
    wd[2 * k + 1] = static_cast<uint32_t>(u >> 32);
  }
}
template <int SZ> struct uint_of;
template <> struct uint_of<1> { using type = uint8_t; };
template <> struct uint_of<2> { using type = uint16_t; };
template <> struct uint_of<4> { using type = uint32_t; };
template <> struct uint_of<8> { using type = uint64_t; };

template <typename T>
MAP_HD T from_slot(const uint32_t* wd, int k) {
  const uint64_t u = slot<sizeof(T)>(wd, k);
  if constexpr (std::is_same<T, bool>::value) {
    return u != 0;
  } else if constexpr (is_half<T>::value) {
    T r;
    r.bits = static_cast<uint16_t>(u);
    return r;
  } else {
    const typename uint_of<sizeof(T)>::type b =
        static_cast<typename uint_of<sizeof(T)>::type>(u);
    T r;
    std::memcpy(&r, &b, sizeof(T));
    return r;
  }
}
template <typename T>
MAP_HD uint64_t to_slot(T v) {
  if constexpr (std::is_same<T, bool>::value) {
    return v ? 1u : 0u;
  } else if constexpr (is_half<T>::value) {
    return v.bits;
  } else {
    typename uint_of<sizeof(T)>::type b;
    std::memcpy(&b, &v, sizeof(T));
    return b;
  }
}

// Sample j of a vector of each storage form held in 32-bit words (as
// `vld_words` loads it; the packed forms' first sample at the start of
// a byte).
template <typename T>
MAP_HD T ex_real(const uint32_t* wd, int j) { return from_slot<T>(wd, j); }
template <typename C>
MAP_HD cx<C> ex_cx(const uint32_t* wd, int j) {
  return cx<C>(from_slot<C>(wd, 2 * j), from_slot<C>(wd, 2 * j + 1));
}
template <typename C, typename I>
MAP_HD cx<C> ex_pair(const uint32_t* wd, int j) {
  return cx<C>(static_cast<C>(from_slot<I>(wd, 2 * j)),
               static_cast<C>(from_slot<I>(wd, 2 * j + 1)));
}
template <typename C>
MAP_HD cx<C> ex_ci4(const uint32_t* wd, int j) {
  return ci4_of<C>(static_cast<uint32_t>(slot<1>(wd, j)));
}
template <typename C, int NBIT>
MAP_HD cx<C> ex_cpacked(const uint32_t* wd, int j) {
  constexpr int PER = 4 / NBIT;
  return cpacked_of<C, NBIT>(static_cast<uint32_t>(slot<1>(wd, j / PER)),
                             j % PER);
}
template <typename T, int NBIT>
MAP_HD T ex_packed(const uint32_t* wd, int j) {
  constexpr int PER = 8 / NBIT;
  return packed_of<T, NBIT>(static_cast<uint32_t>(slot<1>(wd, j / PER)),
                            j % PER);
}

// V logical values from V consecutive samples at storage offset `off`,
// one vector access (the stencil's register window).
template <int V, typename T, typename O>
MAP_HD void vl_real(T* x, const void* p, O off) {
  uint32_t wd[(V * sizeof(T) + 3) / 4];
  vld_words<V * sizeof(T)>(wd, static_cast<const T*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_real<T>(wd, j);
}
template <int V, typename C, typename O>
MAP_HD void vl_cx(cx<C>* x, const void* p, O off) {
  uint32_t wd[V * sizeof(C) / 2];
  vld_words<2 * V * sizeof(C)>(wd, static_cast<const cx<C>*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_cx<C>(wd, j);
}
template <int V, typename C, typename I, typename O>
MAP_HD void vl_pair(cx<C>* x, const void* p, O off) {
  uint32_t wd[(2 * V * sizeof(I) + 3) / 4];
  vld_words<2 * V * sizeof(I)>(wd, static_cast<const I*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_pair<C, I>(wd, j);
}
template <int V, typename C, typename O>
MAP_HD void vl_ci4(cx<C>* x, const void* p, O off) {
  uint32_t wd[(V + 3) / 4];
  vld_words<V>(wd, static_cast<const uint8_t*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_ci4<C>(wd, j);
}
template <int V, typename C, int NBIT, typename O>
MAP_HD void vl_cpacked(cx<C>* x, const void* p, O off) {
  uint32_t wd[(V / (4 / NBIT) + 3) / 4];
  vld_words<V / (4 / NBIT)>(wd, static_cast<const uint8_t*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_cpacked<C, NBIT>(wd, j);
}
template <int V, typename T, int NBIT, typename O>
MAP_HD void vl_packed(T* x, const void* p, O off) {
  uint32_t wd[(V / (8 / NBIT) + 3) / 4];
  vld_words<V / (8 / NBIT)>(wd, static_cast<const uint8_t*>(p) + off);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = ex_packed<T, NBIT>(wd, j);
}

// N values of T (a real type or cx) stored at element offset `off` in
// one vector access (N sizeof(T) bytes, aligned to min(that, 16)).
template <int N, typename T, typename O>
MAP_HD void vst(void* p, O off, const T* v) {
  constexpr int NB = N * static_cast<int>(sizeof(T));
  uint32_t wd[(NB + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (is_cx<T>::value) {
      using C = typename comp<T>::type;
      put_slot<sizeof(C)>(wd, 2 * j, to_slot<C>(v[j].re));
      put_slot<sizeof(C)>(wd, 2 * j + 1, to_slot<C>(v[j].im));
    } else {
      put_slot<sizeof(T)>(wd, j, to_slot<T>(v[j]));
    }
  }
  vst_words<NB>(static_cast<T*>(p) + off, wd);
}

MAP_HD double bits_f64(long long v) {
  union { long long i; double d; } u;
  u.i = v;
  return u.d;
}

}  // namespace bfmap
