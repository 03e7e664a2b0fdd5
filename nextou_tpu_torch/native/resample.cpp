// Native host-side resampling/filtering for the port's data path, carried
// over unchanged from native/resample.cpp (the port keeps its own copy).
//
// The host augmentation (and, once ported, preprocessing and raw-inference
// resampling) funnels through three scipy.ndimage ops: zoom,
// affine_transform, gaussian_filter. This
// translation unit reimplements them as specialized, thread-parallel C++
// (scipy's generic spline machinery pays large per-point dispatch overhead
// and runs single-threaded). Semantics follow scipy.ndimage:
//
// - zoom(order 0/1/3, grid_mode=False): output i samples input at
//   i*(n_in-1)/(n_out-1); order 3 applies the cubic B-spline prefilter
//   (Unser's recursive filter, mirror boundary — scipy >= 1.6 behavior for
//   its default zoom) before evaluating the 4-tap cubic B-spline basis.
// - affine_transform(order 0/1, mode reflect/constant): input coordinate =
//   mat @ output + offset; 'reflect' extends per integer tap (d c b a|a b c d);
//   'constant' order-0 uses scipy's [0, n-1] coordinate domain, order-1 uses
//   [-0.5, n-0.5] with edge-clamped taps.
// - gaussian_filter: per-axis correlation with exp(-0.5 (i/sigma)^2) taps,
//   radius int(4*sigma + 0.5), 'reflect' boundary.
//
// Build: g++ -O3 -shared -fPIC (see nextou_tpu_torch/native/__init__.py); no
// dependencies beyond the C++17 standard library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

using std::int64_t;

// ------------------------------------------------------------------ utils

inline int64_t reflect_index(int64_t idx, int64_t n) {
  // scipy 'reflect' (symmetric): (d c b a | a b c d | d c b a)
  if (n == 1) return 0;
  const int64_t period = 2 * n;
  idx %= period;
  if (idx < 0) idx += period;
  if (idx >= n) idx = period - 1 - idx;
  return idx;
}

inline int64_t mirror_index(int64_t idx, int64_t n) {
  // scipy 'mirror': (d c b | a b c d | c b a) — period 2n-2
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  idx %= period;
  if (idx < 0) idx += period;
  if (idx >= n) idx = period - idx;
  return idx;
}

void parallel_for(int64_t count, int nthreads, const std::function<void(int64_t, int64_t)>& fn) {
  if (nthreads <= 1 || count < 2) {
    fn(0, count);
    return;
  }
  nthreads = static_cast<int>(std::min<int64_t>(nthreads, count));
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  const int64_t chunk = (count + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(count, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------- cubic B-spline bits

// Unser's in-place recursive prefilter for the cubic B-spline, mirror
// boundary (what scipy's spline_filter1d applies for its default modes).
void spline_filter_line(double* c, int64_t n) {
  if (n < 2) return;
  constexpr double z = -0.26794919243112270647;  // sqrt(3) - 2
  const double lambda = (1.0 - z) * (1.0 - 1.0 / z);
  for (int64_t i = 0; i < n; ++i) c[i] *= lambda;
  // causal init (mirror): truncated series, scipy-style full-precision sum
  double sum = c[0];
  double zn = z;
  // |z|^k < eps after ~log(eps)/log|z| ≈ 28 terms; cap at n
  const int64_t horizon = std::min<int64_t>(n, 64);
  for (int64_t k = 1; k < horizon; ++k) {
    sum += zn * c[k];
    zn *= z;
  }
  c[0] = sum;
  for (int64_t i = 1; i < n; ++i) c[i] += z * c[i - 1];
  // anti-causal init (mirror)
  c[n - 1] = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1]);
  for (int64_t i = n - 2; i >= 0; --i) c[i] = z * (c[i + 1] - c[i]);
}

inline void bspline3_weights(double t, double w[4]) {
  // basis at taps floor(x)-1..+2, t = frac(x)
  const double t2 = t * t, t3 = t2 * t;
  w[0] = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0;
  w[1] = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0;
  w[2] = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0;
  w[3] = t3 / 6.0;
}

// Resample one line (gathered into contiguous `in`, length n_in) to
// `out[i*out_stride]`, scipy zoom mapping, given order.
void resample_line(const float* in, int64_t n_in, float* out, int64_t n_out,
                   int64_t out_stride, int order, double* scratch) {
  const double step =
      (n_out > 1 && n_in > 1) ? static_cast<double>(n_in - 1) / (n_out - 1) : 0.0;
  if (order == 0) {
    for (int64_t i = 0; i < n_out; ++i) {
      const double x = i * step;
      int64_t j = static_cast<int64_t>(std::floor(x + 0.5));
      j = std::clamp<int64_t>(j, 0, n_in - 1);
      out[i * out_stride] = in[j];
    }
    return;
  }
  if (order == 1) {
    for (int64_t i = 0; i < n_out; ++i) {
      const double x = i * step;
      const int64_t j = std::min<int64_t>(static_cast<int64_t>(x), n_in - 2 >= 0 ? n_in - 2 : 0);
      const double f = x - j;
      out[i * out_stride] =
          static_cast<float>((1.0 - f) * in[j] + f * in[std::min<int64_t>(j + 1, n_in - 1)]);
    }
    return;
  }
  // order 3: prefilter into scratch, then 4-tap basis with mirror taps
  for (int64_t j = 0; j < n_in; ++j) scratch[j] = in[j];
  spline_filter_line(scratch, n_in);
  for (int64_t i = 0; i < n_out; ++i) {
    const double x = i * step;
    const int64_t base = static_cast<int64_t>(std::floor(x));
    double w[4];
    bspline3_weights(x - base, w);
    double acc = 0.0;
    for (int t = 0; t < 4; ++t) {
      const int64_t tap = mirror_index(base - 1 + t, n_in);
      acc += w[t] * scratch[tap];
    }
    out[i * out_stride] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" {

// Separable zoom along every axis (scipy.ndimage.zoom semantics,
// grid_mode=False). shapes are int64[ndim]; ndim <= 4. Returns 0 on success.
int nxt_zoom_f32(const float* src, const int64_t* in_shape, float* dst,
                 const int64_t* out_shape, int ndim, int order, int nthreads) {
  if (ndim < 1 || ndim > 4 || (order != 0 && order != 1 && order != 3)) return 1;

  std::vector<int64_t> cur(in_shape, in_shape + ndim);
  std::vector<float> buf_a(src, src + [&] {
    int64_t n = 1;
    for (int d = 0; d < ndim; ++d) n *= in_shape[d];
    return n;
  }());
  std::vector<float> buf_b;

  for (int axis = 0; axis < ndim; ++axis) {
    const int64_t n_in = cur[axis];
    const int64_t n_out = out_shape[axis];
    if (n_in == n_out) continue;
    std::vector<int64_t> next = cur;
    next[axis] = n_out;
    int64_t total_next = 1, inner = 1, outer = 1;
    for (int d = 0; d < ndim; ++d) total_next *= next[d];
    for (int d = axis + 1; d < ndim; ++d) inner *= cur[d];
    for (int d = 0; d < axis; ++d) outer *= cur[d];
    buf_b.resize(total_next);
    const float* in = buf_a.data();
    float* out = buf_b.data();
    const int64_t lines = outer * inner;
    parallel_for(lines, nthreads, [&](int64_t lo, int64_t hi) {
      std::vector<float> line(n_in);
      std::vector<double> scratch(order == 3 ? n_in : 0);
      for (int64_t l = lo; l < hi; ++l) {
        const int64_t o = l / inner, r = l % inner;
        const float* ip = in + (o * n_in) * inner + r;
        float* op = out + (o * n_out) * inner + r;
        for (int64_t j = 0; j < n_in; ++j) line[j] = ip[j * inner];
        resample_line(line.data(), n_in, op, n_out, inner, order, scratch.data());
      }
    });
    buf_a.swap(buf_b);
    cur = next;
  }
  int64_t total = 1;
  for (int d = 0; d < ndim; ++d) total *= out_shape[d];
  std::memcpy(dst, buf_a.data(), total * sizeof(float));
  return 0;
}

// Affine resample, 3D or 2D: dst[o] = src[mat @ o + off].
// order: 0 (nearest) or 1 (linear); mode: 0 = reflect, 1 = constant(cval).
int nxt_affine_f32(const float* src, const int64_t* shape, int ndim,
                   const double* mat, const double* off, float* dst, int order,
                   int mode, float cval, int nthreads) {
  if (ndim != 2 && ndim != 3) return 1;
  if (order != 0 && order != 1) return 1;
  const int64_t n0 = shape[0], n1 = shape[1], n2 = (ndim == 3) ? shape[2] : 1;

  auto body = [&](int64_t z0, int64_t z1) {
    for (int64_t i0 = z0; i0 < z1; ++i0)
      for (int64_t i1 = 0; i1 < n1; ++i1) {
        // coordinates advance linearly along the innermost axis: start at
        // i2 = 0 and increment by the matrix's last column
        double c0[3], dc[3] = {0.0, 0.0, 0.0};
        if (ndim == 3) {
          c0[0] = mat[0] * i0 + mat[1] * i1 + off[0];
          c0[1] = mat[3] * i0 + mat[4] * i1 + off[1];
          c0[2] = mat[6] * i0 + mat[7] * i1 + off[2];
          dc[0] = mat[2]; dc[1] = mat[5]; dc[2] = mat[8];
        } else {
          c0[0] = mat[0] * i0 + mat[1] * i1 + off[0];
          c0[1] = mat[2] * i0 + mat[3] * i1 + off[1];
          c0[2] = 0.0;
        }
        for (int64_t i2 = 0; i2 < n2; ++i2) {
          const double c[3] = {c0[0] + dc[0] * i2, c0[1] + dc[1] * i2,
                               c0[2] + dc[2] * i2};
          float* o = dst + (i0 * n1 + i1) * n2 + i2;
          const int64_t ns[3] = {n0, n1, n2};
          if (order == 0) {
            bool ok = true;
            int64_t idx[3] = {0, 0, 0};
            for (int d = 0; d < ndim; ++d) {
              if (mode == 1) {  // constant: domain [0, n-1] (scipy order-0)
                if (c[d] < 0.0 || c[d] > ns[d] - 1) { ok = false; break; }
              }
              int64_t j = static_cast<int64_t>(std::floor(c[d] + 0.5));
              idx[d] = (mode == 1) ? std::clamp<int64_t>(j, 0, ns[d] - 1)
                                   : reflect_index(j, ns[d]);
            }
            *o = ok ? src[(idx[0] * n1 + idx[1]) * n2 + idx[2]] : cval;
            continue;
          }
          // order 1
          bool inside = true;
          int64_t lo[3] = {0, 0, 0};
          double f[3] = {0.0, 0.0, 0.0};
          for (int d = 0; d < ndim; ++d) {
            if (mode == 1 && (c[d] < -0.5 || c[d] > ns[d] - 0.5)) inside = false;
            const double fl = std::floor(c[d]);
            lo[d] = static_cast<int64_t>(fl);
            f[d] = c[d] - fl;
          }
          if (!inside) { *o = cval; continue; }
          bool interior = true;
          for (int d = 0; d < ndim; ++d)
            interior &= (lo[d] >= 0) && (lo[d] + 1 <= ns[d] - 1);
          if (interior && ndim == 3) {
            const float* p = src + (lo[0] * n1 + lo[1]) * n2 + lo[2];
            const double f0 = f[0], f1 = f[1], f2 = f[2];
            const double g0 = 1.0 - f0, g1 = 1.0 - f1, g2 = 1.0 - f2;
            const int64_t s1 = n2, s0 = n1 * n2;
            const double v00 = g2 * p[0] + f2 * p[1];
            const double v01 = g2 * p[s1] + f2 * p[s1 + 1];
            const double v10 = g2 * p[s0] + f2 * p[s0 + 1];
            const double v11 = g2 * p[s0 + s1] + f2 * p[s0 + s1 + 1];
            *o = static_cast<float>(g0 * (g1 * v00 + f1 * v01) +
                                    f0 * (g1 * v10 + f1 * v11));
            continue;
          }
          double acc = 0.0;
          const int corners = 1 << ndim;
          for (int corner = 0; corner < corners; ++corner) {
            double w = 1.0;
            int64_t idx[3] = {0, 0, 0};
            for (int d = 0; d < ndim; ++d) {
              const int hi = (corner >> d) & 1;
              w *= hi ? f[d] : 1.0 - f[d];
              int64_t tap = lo[d] + hi;
              idx[d] = (mode == 1) ? std::clamp<int64_t>(tap, 0, ns[d] - 1)
                                   : reflect_index(tap, ns[d]);
            }
            acc += w * src[(idx[0] * n1 + idx[1]) * n2 + idx[2]];
          }
          *o = static_cast<float>(acc);
        }
      }
  };
  parallel_for(n0, nthreads, body);
  return 0;
}

// Separable Gaussian, 'reflect' boundary, scipy's kernel/radius convention.
int nxt_gaussian_f32(const float* src, const int64_t* shape, int ndim,
                     double sigma, float* dst, int nthreads) {
  if (ndim < 1 || ndim > 4) return 1;
  const int64_t radius = static_cast<int64_t>(4.0 * sigma + 0.5);
  std::vector<double> k(2 * radius + 1);
  double ksum = 0.0;
  for (int64_t i = -radius; i <= radius; ++i) {
    k[i + radius] = std::exp(-0.5 * (i / sigma) * (i / sigma));
    ksum += k[i + radius];
  }
  for (auto& v : k) v /= ksum;

  int64_t total = 1;
  for (int d = 0; d < ndim; ++d) total *= shape[d];
  std::vector<float> buf(src, src + total);
  std::vector<float> out(total);

  for (int axis = 0; axis < ndim; ++axis) {
    const int64_t n = shape[axis];
    int64_t inner = 1, outer = 1;
    for (int d = axis + 1; d < ndim; ++d) inner *= shape[d];
    for (int d = 0; d < axis; ++d) outer *= shape[d];
    const float* in = buf.data();
    float* op = out.data();
    const int64_t klen = 2 * radius + 1;
    std::vector<float> kf(k.begin(), k.end());
    parallel_for(outer * inner, nthreads, [&](int64_t lo, int64_t hi) {
      // reflect-pad each line once so the correlation inner loop is a plain
      // contiguous FMA the compiler can vectorize
      std::vector<float> pad(n + 2 * radius);
      for (int64_t l = lo; l < hi; ++l) {
        const int64_t o = l / inner, r = l % inner;
        const float* ip = in + (o * n) * inner + r;
        for (int64_t j = -radius; j < n + radius; ++j)
          pad[j + radius] = ip[reflect_index(j, n) * inner];
        float* wp = op + (o * n) * inner + r;
        for (int64_t j = 0; j < n; ++j) {
          float acc = 0.0f;
          const float* pp = pad.data() + j;
          for (int64_t t = 0; t < klen; ++t) acc += kf[t] * pp[t];
          wp[j * inner] = acc;
        }
      }
    });
    buf.swap(out);
  }
  std::memcpy(dst, buf.data(), total * sizeof(float));
  return 0;
}

}  // extern "C"
