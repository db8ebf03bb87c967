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
// Every function is __host__ __device__, so a generated source also
// compiles with the host C++ compiler: the CPU tests run the generated
// statement bodies against the plain engine with no card.  Kernels are
// built with --fmad=false (and the host build with -ffp-contract=off),
// so no multiply and add are contracted: the plain engine rounds each
// operator on its own.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#define MAP_HD __host__ __device__ __forceinline__
#else
#define MAP_HD inline
#endif

namespace bfmap {

template <typename T>
struct cx {
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
  if constexpr (is_cx<T>::value) {
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
  if constexpr (is_cx<T>::value) {
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
  if constexpr (is_cx<T>::value) {
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
  if constexpr (is_cx<T>::value) {
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
  if constexpr (is_cx<T>::value) {
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
  if constexpr (std::is_integral<T>::value) {
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
  if constexpr (std::is_integral<T>::value) {
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
  if constexpr (std::is_integral<T>::value) {
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
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a < b ? a : b;
}
template <typename T>
MAP_HD T mmax(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a > b ? a : b;
}

template <typename T>
MAP_HD T mabs(T a) {
  if constexpr (std::is_integral<T>::value) {
    return a < 0 ? op_neg<T>(a) : a;
  } else {
    return std::fabs(a);
  }
}
template <typename C>
MAP_HD C mabs(cx<C> a) { return std::hypot(a.re, a.im); }

template <typename T> MAP_HD T mfloor(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else return std::floor(a);
}
template <typename T> MAP_HD T mceil(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else return std::ceil(a);
}
// Half to even, as jnp.round and torch.round.
template <typename T> MAP_HD T mrint(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else return std::rint(a);
}
template <typename T> MAP_HD T mrsqrt(T a) { return T(1) / std::sqrt(a); }

template <typename C>
MAP_HD cx<C> mexp(cx<C> a) {
  C m = std::exp(a.re);
  return cx<C>(m * std::cos(a.im), m * std::sin(a.im));
}
template <typename T> MAP_HD T mexp(T a) { return std::exp(a); }

template <typename C>
MAP_HD cx<C> mconj(cx<C> a) { return cx<C>(a.re, -a.im); }
template <typename C>
MAP_HD C mmag2(cx<C> a) { return a.re * a.re + a.im * a.im; }

// ----------------------------------------------- loads by storage form
template <typename T>
MAP_HD T ld_real(const void* p, long long off) {
  return static_cast<const T*>(p)[off];
}
// A complex tensor: (re, im) pairs of its component type.
template <typename C>
MAP_HD cx<C> ld_cx(const void* p, long long off) {
  const C* q = static_cast<const C*>(p) + 2 * off;
  return cx<C>(q[0], q[1]);
}
// Complex-integer ring storage (ci8, ci16, ci32): the integer component
// type with a trailing (re, im) axis, `cs` elements between the two.
template <typename C, typename I>
MAP_HD cx<C> ld_pair(const void* p, long long off, long long cs) {
  const I* q = static_cast<const I*>(p) + off;
  return cx<C>(static_cast<C>(q[0]), static_cast<C>(q[cs]));
}
// Packed ci4: one sample a byte, the real part in the high nibble
// (MSB first), each nibble sign-extended (ops/unpack.py).
template <typename C>
MAP_HD cx<C> ld_ci4(const void* p, long long off) {
  uint8_t b = static_cast<const uint8_t*>(p)[off];
  int re = static_cast<int8_t>(b & 0xF0) >> 4;
  int im = static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
  return cx<C>(static_cast<C>(re), static_cast<C>(im));
}
// Packed real storage (i4/u4, i2/u2, i1/u1): 8 / NBIT samples a byte
// along the last axis, MSB first; a signed field is sign-extended by
// the shifts of ops/unpack.py.  `off` is the byte, `pos` the field.
template <typename T, int NBIT>
MAP_HD T ld_packed(const void* p, long long off, long long pos) {
  constexpr int PER = 8 / NBIT;
  const uint8_t b = static_cast<const uint8_t*>(p)[off];
  const uint8_t v = static_cast<uint8_t>(
      (b >> ((PER - 1 - pos) * NBIT)) & ((1 << NBIT) - 1));
  if constexpr (std::is_signed<T>::value) {
    return static_cast<T>(
        static_cast<int8_t>(static_cast<uint8_t>(v << (8 - NBIT))) >>
        (8 - NBIT));
  } else {
    return static_cast<T>(v);
  }
}

template <typename T>
MAP_HD void st(void* p, long long off, T v) {
  if constexpr (is_cx<T>::value) {
    using C = typename comp<T>::type;
    C* q = static_cast<C*>(p) + 2 * off;
    q[0] = v.re;
    q[1] = v.im;
  } else {
    static_cast<T*>(p)[off] = v;
  }
}

// A gather index as jnp indexing takes it: a negative index wraps once,
// then the index is clamped to the axis.
MAP_HD long long wrapclamp(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

MAP_HD double bits_f64(long long v) {
  union { long long i; double d; } u;
  u.i = v;
  return u.d;
}

}  // namespace bfmap
