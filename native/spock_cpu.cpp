// High-performance CPU solver for multistage risk-averse optimal control on
// uniform scenario trees — the native baseline tier of spock_tpu.
//
// Role: the independent, dependency-free CPU counterpart of the JAX
// engine (filling the niche the reference delegates to external JuMP
// backends, /root/reference/src/models/model_mosek.jl).  It implements the
// same splitting — Chambolle-Pock with Riccati/kernel/cone projections,
// optionally SuperMann + Anderson — in double precision on flat node-major
// arrays.  The offline factorizations (Riccati factors, kernel projectors,
// matrix square roots, ||L||^2) are computed by the Python side (numpy) and
// passed in; this file contains only the online iteration.
//
// Exposed as a C ABI consumed via ctypes (spock_tpu/baselines/native.py).
// Build: see native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Problem container
// ---------------------------------------------------------------------------

struct Problem {
  // sizes
  int N, d, nx, nu, ny;
  long n, n_nonleaf, n_leaf;

  // dynamics / data (borrowed pointers, row-major)
  const double *A;       // [d, nx, nx]
  const double *B;       // [d, nx, nu]
  const double *sqrtQ;   // [nx, nx]   (uniform across nodes)
  const double *sqrtR;   // [nu, nu]
  const double *sqrtQN;  // [nx, nx]
  const double *bvec;    // [ny] uniform | [n_nonleaf, ny] per-node
  const double *ker;     // [m, m] | [n_nonleaf, m, m], m = ny + 2d
  int risk_per_node;     // bvec/ker carry a leading node axis when set
  // Riccati factors, stage-uniform: for stage t in [0, N-1)
  const double *K;     // [N-1, nu, nx]
  const double *Rtinv; // [N-1, nu, nu]
  const double *ABK;   // [N-1, d, nx, nx]
  const double *PB;    // [N-1, d, nx, nu]
  // box (per-dimension bounds)
  const double *x_min, *x_max;  // [nx]
  const double *u_min, *u_max;  // [nu]
  // two-sided polytopic constraints Gx x + Gu u in [plo, phi] per non-leaf,
  // GxN x in [ploN, phiN] per leaf (0 rows = absent)
  int nc, ncL;
  const double *Gx, *Gu, *plo, *phi;    // [nc,nx],[nc,nu],[nc],[nc]
  const double *GxN, *ploN, *phiN;      // [ncL,nx],[ncL],[ncL]
  // cone spec for K* applied to y: for AV@R this is nonneg on the first
  // ny_nonneg entries, free on the rest. General product cones are encoded
  // as segment lists (kind, dim).
  const int32_t *cone_kinds;  // 0 zero, 1 nonneg, 2 nonpos, 3 reals, 4 soc
  const int32_t *cone_dims;
  int n_cones;

  long stage_off(int t) const {
    // (d^t - 1) / (d - 1)
    long p = 1;
    long acc = 0;
    for (int i = 0; i < t; ++i) { acc += p; p *= d; }
    return acc;
  }
};

struct Work {
  // primal z = [x, u, s, tau, y] and dual v blocks, flat
  long nz, nv;
  std::vector<double> q;       // costate [n*nx]
  std::vector<double> dvec;    // feedforward [n_nonleaf*nu]
  std::vector<double> soc;     // scratch cone vec
};

// offsets into z
struct ZOff {
  long x, u, s, tau, y, nz;
};
static ZOff zoff(const Problem &p) {
  ZOff o;
  o.x = 0;
  o.u = o.x + p.n * p.nx;
  o.s = o.u + p.n_nonleaf * p.nu;
  o.tau = o.s + p.n;
  o.y = o.tau + (p.n - 1);
  o.nz = o.y + p.n_nonleaf * p.ny;
  return o;
}
// offsets into v (polytope dual rows pnl/plf appended, sized by nc/ncL)
struct VOff {
  long y, sby, qx, ru, t5, t6, cx, cu, qNx, s12, s13, cxN, pnl, plf, nv;
};
static VOff voff(const Problem &p) {
  VOff o;
  o.y = 0;
  o.sby = o.y + p.n_nonleaf * p.ny;
  o.qx = o.sby + p.n_nonleaf;
  o.ru = o.qx + (p.n - 1) * p.nx;
  o.t5 = o.ru + (p.n - 1) * p.nu;
  o.t6 = o.t5 + (p.n - 1);
  o.cx = o.t6 + (p.n - 1);
  o.cu = o.cx + p.n_nonleaf * p.nx;
  o.qNx = o.cu + p.n_nonleaf * p.nu;
  o.s12 = o.qNx + p.n_leaf * p.nx;
  o.s13 = o.s12 + p.n_leaf;
  o.cxN = o.s13 + p.n_leaf;
  o.pnl = o.cxN + p.n_leaf * p.nx;
  o.plf = o.pnl + p.n_nonleaf * p.nc;
  o.nv = o.plf + p.n_leaf * p.ncL;
  return o;
}

// y = M x (rows r, cols c), accumulate flag
static inline void matvec(const double *M, const double *x, double *y, int r,
                          int c, bool acc) {
  for (int i = 0; i < r; ++i) {
    double s = acc ? y[i] : 0.0;
    const double *row = M + (long)i * c;
    for (int j = 0; j < c; ++j) s += row[j] * x[j];
    y[i] = s;
  }
}
// y = M' x
static inline void matvecT(const double *M, const double *x, double *y, int r,
                           int c, bool acc) {
  if (!acc) std::fill(y, y + c, 0.0);
  for (int i = 0; i < r; ++i) {
    const double xi = x[i];
    const double *row = M + (long)i * c;
    for (int j = 0; j < c; ++j) y[j] += row[j] * xi;
  }
}

// ---------------------------------------------------------------------------
// L and L'   (cf. spock_tpu/ops/linop.py; reference implicit_l.jl:177-449)
// ---------------------------------------------------------------------------

static void apply_L(const Problem &p, const double *z, double *v) {
  ZOff zo = zoff(p);
  VOff vo = voff(p);
  const long nnl = p.n_nonleaf, nlf = p.n_leaf, n = p.n;
  // v1 = y
  std::memcpy(v + vo.y, z + zo.y, sizeof(double) * nnl * p.ny);
  // v2 = s_i - b_i'y_i
  for (long i = 0; i < nnl; ++i) {
    double dot = 0;
    const double *yi = z + zo.y + i * p.ny;
    const double *bi = p.bvec + (p.risk_per_node ? i * p.ny : 0);
    for (int k = 0; k < p.ny; ++k) dot += bi[k] * yi[k];
    v[vo.sby + i] = z[zo.s + i] - dot;
  }
  // v3/v4: sqrtQ x_par, sqrtR u_par; v5/v6 = tau/2 (non-root j = 1..n-1)
  for (long j = 1; j < n; ++j) {
    long par = (j - 1) / p.d;
    matvec(p.sqrtQ, z + zo.x + par * p.nx, v + vo.qx + (j - 1) * p.nx, p.nx,
           p.nx, false);
    matvec(p.sqrtR, z + zo.u + par * p.nu, v + vo.ru + (j - 1) * p.nu, p.nu,
           p.nu, false);
    v[vo.t5 + j - 1] = 0.5 * z[zo.tau + j - 1];
    v[vo.t6 + j - 1] = 0.5 * z[zo.tau + j - 1];
  }
  // v7 = (x_i, u_i) non-leaf
  std::memcpy(v + vo.cx, z + zo.x, sizeof(double) * nnl * p.nx);
  std::memcpy(v + vo.cu, z + zo.u, sizeof(double) * nnl * p.nu);
  // leaves
  for (long k = 0; k < nlf; ++k) {
    long i = nnl + k;
    matvec(p.sqrtQN, z + zo.x + i * p.nx, v + vo.qNx + k * p.nx, p.nx, p.nx,
           false);
    v[vo.s12 + k] = 0.5 * z[zo.s + i];
    v[vo.s13 + k] = 0.5 * z[zo.s + i];
  }
  std::memcpy(v + vo.cxN, z + zo.x + nnl * p.nx, sizeof(double) * nlf * p.nx);
  // polytope rows: Gx x_i + Gu u_i (non-leaf), GxN x_i (leaf)
  for (long i = 0; i < nnl && p.nc; ++i) {
    double *pi = v + vo.pnl + i * p.nc;
    matvec(p.Gx, z + zo.x + i * p.nx, pi, p.nc, p.nx, false);
    matvec(p.Gu, z + zo.u + i * p.nu, pi, p.nc, p.nu, true);
  }
  for (long k = 0; k < nlf && p.ncL; ++k)
    matvec(p.GxN, z + zo.x + (nnl + k) * p.nx, v + vo.plf + k * p.ncL, p.ncL,
           p.nx, false);
}

static void apply_LT(const Problem &p, const double *v, double *z) {
  ZOff zo = zoff(p);
  VOff vo = voff(p);
  const long nnl = p.n_nonleaf, nlf = p.n_leaf, n = p.n;
  // x non-leaf: cx + sum_children sqrtQ' qx_j
  std::memcpy(z + zo.x, v + vo.cx, sizeof(double) * nnl * p.nx);
  for (long j = 1; j < n; ++j) {
    long par = (j - 1) / p.d;
    if (par < nnl)
      matvecT(p.sqrtQ, v + vo.qx + (j - 1) * p.nx, z + zo.x + par * p.nx, p.nx,
              p.nx, true);
  }
  // x leaf: cxN + sqrtQN' qNx
  std::memcpy(z + zo.x + nnl * p.nx, v + vo.cxN, sizeof(double) * nlf * p.nx);
  for (long k = 0; k < nlf; ++k) {
    long i = nnl + k;
    matvecT(p.sqrtQN, v + vo.qNx + k * p.nx, z + zo.x + i * p.nx, p.nx, p.nx,
            true);
  }
  // u: cu + sum_children sqrtR' ru_j
  std::memcpy(z + zo.u, v + vo.cu, sizeof(double) * nnl * p.nu);
  for (long j = 1; j < n; ++j) {
    long par = (j - 1) / p.d;
    matvecT(p.sqrtR, v + vo.ru + (j - 1) * p.nu, z + zo.u + par * p.nu, p.nu,
            p.nu, true);
  }
  // y = v1 - b_i * v2
  for (long i = 0; i < nnl; ++i) {
    const double s2 = v[vo.sby + i];
    const double *bi = p.bvec + (p.risk_per_node ? i * p.ny : 0);
    for (int k = 0; k < p.ny; ++k)
      z[zo.y + i * p.ny + k] = v[vo.y + i * p.ny + k] - bi[k] * s2;
  }
  // polytope adjoints into x/u
  for (long i = 0; i < nnl && p.nc; ++i) {
    const double *pi = v + vo.pnl + i * p.nc;
    matvecT(p.Gx, pi, z + zo.x + i * p.nx, p.nc, p.nx, true);
    matvecT(p.Gu, pi, z + zo.u + i * p.nu, p.nc, p.nu, true);
  }
  for (long k = 0; k < nlf && p.ncL; ++k)
    matvecT(p.GxN, v + vo.plf + k * p.ncL, z + zo.x + (nnl + k) * p.nx, p.ncL,
            p.nx, true);
  // tau = (t5 + t6)/2 ; s
  for (long j = 1; j < n; ++j)
    z[zo.tau + j - 1] = 0.5 * (v[vo.t5 + j - 1] + v[vo.t6 + j - 1]);
  for (long i = 0; i < nnl; ++i) z[zo.s + i] = v[vo.sby + i];
  for (long k = 0; k < nlf; ++k)
    z[zo.s + nnl + k] = 0.5 * (v[vo.s12 + k] + v[vo.s13 + k]);
}

// ---------------------------------------------------------------------------
// prox_f: Riccati S1 + kernel S2   (cf. implicit_l.jl:559-750)
// ---------------------------------------------------------------------------

static void projection_S1(const Problem &p, double *x, double *u,
                          const double *x0, Work &w) {
  const int nx = p.nx, nu = p.nu, d = p.d;
  const long nnl = p.n_nonleaf, n = p.n;
  double *q = w.q.data();
  double *dv = w.dvec.data();
  double tmpu[64], tmpx[64], tmpx2[64];
  // leaves: q_i = -x_i
  for (long i = nnl; i < n; ++i)
    for (int k = 0; k < nx; ++k) q[i * nx + k] = -x[i * nx + k];
  // backward
  for (long i = nnl - 1; i >= 0; --i) {
    int t = 0;  // stage of node i
    {
      long acc = 0, pw = 1;
      while (acc + pw <= i) { acc += pw; pw *= d; ++t; }
    }
    const double *Kt = p.K + (long)t * nu * nx;
    const double *Rt = p.Rtinv + (long)t * nu * nu;
    const double *ABKt = p.ABK + (long)t * d * nx * nx;
    const double *PBt = p.PB + (long)t * d * nx * nu;
    // sum_for_d = sum_j B[w]' q_j
    double sum_d[64];
    std::fill(sum_d, sum_d + nu, 0.0);
    for (int c = 0; c < d; ++c) {
      long j = d * i + 1 + c;
      matvecT(p.B + (long)c * nx * nu, q + j * nx, sum_d, nx, nu, true);
    }
    // dvec_i = Rtinv (u_i - sum_d)
    for (int k = 0; k < nu; ++k) tmpu[k] = u[i * nu + k] - sum_d[k];
    matvec(Rt, tmpu, dv + i * nu, nu, nu, false);
    // q_i = sum_j ABK_j'(PB_j d_i + q_j) + K'(d_i - u_i) - x_i
    double *qi = q + i * nx;
    std::fill(qi, qi + nx, 0.0);
    for (int c = 0; c < d; ++c) {
      long j = d * i + 1 + c;
      matvec(PBt + (long)c * nx * nu, dv + i * nu, tmpx, nx, nu, false);
      for (int k = 0; k < nx; ++k) tmpx[k] += q[j * nx + k];
      matvecT(ABKt + (long)c * nx * nx, tmpx, qi, nx, nx, true);
    }
    for (int k = 0; k < nu; ++k) tmpu[k] = dv[i * nu + k] - u[i * nu + k];
    matvecT(Kt, tmpu, qi, nu, nx, true);
    for (int k = 0; k < nx; ++k) qi[k] -= x[i * nx + k];
  }
  // forward
  for (int k = 0; k < nx; ++k) x[k] = x0[k];
  for (long i = 0; i < nnl; ++i) {
    int t = 0;
    {
      long acc = 0, pw = 1;
      while (acc + pw <= i) { acc += pw; pw *= d; ++t; }
    }
    const double *Kt = p.K + (long)t * nu * nx;
    const double *ABKt = p.ABK + (long)t * d * nx * nx;
    // u_i = K x_i + d_i
    matvec(Kt, x + i * nx, u + i * nu, nu, nx, false);
    for (int k = 0; k < nu; ++k) u[i * nu + k] += dv[i * nu + k];
    for (int c = 0; c < d; ++c) {
      long j = d * i + 1 + c;
      matvec(ABKt + (long)c * nx * nx, x + i * nx, x + j * nx, nx, nx, false);
      matvec(p.B + (long)c * nx * nu, dv + i * nu, tmpx2, nx, nu, false);
      for (int k = 0; k < nx; ++k) x[j * nx + k] += tmpx2[k];
    }
  }
}

static void projection_S2(const Problem &p, double *s1, double *tau, double *y,
                          Work &w) {
  // per non-leaf i: [y_i; s_children; tau_children] <- ker * same
  const int m = p.ny + 2 * p.d;
  double vec[256], out[256];
  for (long i = 0; i < p.n_nonleaf; ++i) {
    for (int k = 0; k < p.ny; ++k) vec[k] = y[i * p.ny + k];
    for (int c = 0; c < p.d; ++c) {
      long j = p.d * i + c;  // child index - 1 (non-root index)
      vec[p.ny + c] = s1[j];
      vec[p.ny + p.d + c] = tau[j];
    }
    matvec(p.ker + (p.risk_per_node ? i * (long)m * m : 0), vec, out, m, m,
           false);
    for (int k = 0; k < p.ny; ++k) y[i * p.ny + k] = out[k];
    for (int c = 0; c < p.d; ++c) {
      long j = p.d * i + c;
      s1[j] = out[p.ny + c];
      tau[j] = out[p.ny + p.d + c];
    }
  }
}

static void prox_f(const Problem &p, double *z, double gamma, const double *x0,
                   Work &w) {
  ZOff zo = zoff(p);
  z[zo.s] -= gamma;
  projection_S1(p, z + zo.x, z + zo.u, x0, w);
  projection_S2(p, z + zo.s + 1, z + zo.tau, z + zo.y, w);
}

// ---------------------------------------------------------------------------
// prox_h* (Moreau; cf. implicit_l.jl:752-951)
// ---------------------------------------------------------------------------

static inline void soc_project(double *vec, int len) {
  // vec = (t, x); MOI ordering
  double t = vec[0];
  double nrm = 0;
  for (int k = 1; k < len; ++k) nrm += vec[k] * vec[k];
  nrm = std::sqrt(nrm);
  if (nrm <= t) return;
  if (nrm <= -t) {
    std::fill(vec, vec + len, 0.0);
    return;
  }
  double tn = 0.5 * (t + nrm);
  vec[0] = tn;
  double scale = tn / nrm;
  for (int k = 1; k < len; ++k) vec[k] *= scale;
}

static void prox_h_conj(const Problem &p, double *v, double sigma, Work &w) {
  VOff vo = voff(p);
  const long nnl = p.n_nonleaf, nlf = p.n_leaf, n = p.n;
  const double inv = 1.0 / sigma;
  // w = v / sigma with +-1/2 shifts; then proj; then v = sigma (w - proj)
  // do it blockwise to keep one pass per block.
  // -- y block: w, then project onto dual cone segments
  for (long i = 0; i < nnl; ++i) {
    double *yi = v + vo.y + i * p.ny;
    int off = 0;
    double wv[256];
    for (int k = 0; k < p.ny; ++k) wv[k] = yi[k] * inv;
    double pv[256];
    std::memcpy(pv, wv, sizeof(double) * p.ny);
    for (int csec = 0; csec < p.n_cones; ++csec) {
      int kind = p.cone_kinds[csec], dim = p.cone_dims[csec];
      // dual cone of the section (we receive the DUAL cone spec directly)
      if (kind == 0) {  // zero -> projection = 0
        for (int k = 0; k < dim; ++k) pv[off + k] = 0.0;
      } else if (kind == 1) {  // nonneg
        for (int k = 0; k < dim; ++k) pv[off + k] = std::max(wv[off + k], 0.0);
      } else if (kind == 2) {  // nonpos
        for (int k = 0; k < dim; ++k) pv[off + k] = std::min(wv[off + k], 0.0);
      } else if (kind == 3) {  // reals: identity
      } else if (kind == 4) {  // soc
        soc_project(pv + off, dim);
      }
      off += dim;
    }
    for (int k = 0; k < p.ny; ++k) yi[k] = sigma * (wv[k] - pv[k]);
  }
  // -- sby: clip >= 0
  for (long i = 0; i < nnl; ++i) {
    double wv = v[vo.sby + i] * inv;
    double pv = std::max(wv, 0.0);
    v[vo.sby + i] = sigma * (wv - pv);
  }
  // -- non-root SOCs (t6, qx, ru, t5)
  {
    const int len = p.nx + p.nu + 2;
    double vec[160], wv[160];
    for (long j = 0; j < n - 1; ++j) {
      vec[0] = v[vo.t6 + j] * inv + 0.5;
      for (int k = 0; k < p.nx; ++k) vec[1 + k] = v[vo.qx + j * p.nx + k] * inv;
      for (int k = 0; k < p.nu; ++k)
        vec[1 + p.nx + k] = v[vo.ru + j * p.nu + k] * inv;
      vec[len - 1] = v[vo.t5 + j] * inv - 0.5;
      std::memcpy(wv, vec, sizeof(double) * len);
      soc_project(vec, len);
      v[vo.t6 + j] = sigma * (wv[0] - vec[0]);
      for (int k = 0; k < p.nx; ++k)
        v[vo.qx + j * p.nx + k] = sigma * (wv[1 + k] - vec[1 + k]);
      for (int k = 0; k < p.nu; ++k)
        v[vo.ru + j * p.nu + k] = sigma * (wv[1 + p.nx + k] - vec[1 + p.nx + k]);
      v[vo.t5 + j] = sigma * (wv[len - 1] - vec[len - 1]);
    }
  }
  // -- leaf SOCs (s13, qNx, s12)
  {
    const int len = p.nx + 2;
    double vec[160], wv[160];
    for (long k2 = 0; k2 < nlf; ++k2) {
      vec[0] = v[vo.s13 + k2] * inv + 0.5;
      for (int k = 0; k < p.nx; ++k)
        vec[1 + k] = v[vo.qNx + k2 * p.nx + k] * inv;
      vec[len - 1] = v[vo.s12 + k2] * inv - 0.5;
      std::memcpy(wv, vec, sizeof(double) * len);
      soc_project(vec, len);
      v[vo.s13 + k2] = sigma * (wv[0] - vec[0]);
      for (int k = 0; k < p.nx; ++k)
        v[vo.qNx + k2 * p.nx + k] = sigma * (wv[1 + k] - vec[1 + k]);
      v[vo.s12 + k2] = sigma * (wv[len - 1] - vec[len - 1]);
    }
  }
  // -- boxes (per-dimension bounds)
  auto box = [&](double *ptr, long count, int dim, const double *lo,
                 const double *hi) {
    for (long k = 0; k < count; ++k) {
      int j = (int)(k % dim);
      double wv = ptr[k] * inv;
      double pv = std::min(std::max(wv, lo[j]), hi[j]);
      ptr[k] = sigma * (wv - pv);
    }
  };
  box(v + vo.cx, nnl * p.nx, p.nx, p.x_min, p.x_max);
  box(v + vo.cu, nnl * p.nu, p.nu, p.u_min, p.u_max);
  box(v + vo.cxN, nlf * p.nx, p.nx, p.x_min, p.x_max);
  // -- polytope rows: two-sided clip onto [plo, phi] (cf. ops/prox.py:130)
  if (p.nc) box(v + vo.pnl, nnl * p.nc, p.nc, p.plo, p.phi);
  if (p.ncL) box(v + vo.plf, nlf * p.ncL, p.ncL, p.ploN, p.phiN);
}

// ---------------------------------------------------------------------------
// CP + SuperMann loops  (cf. cp.jl:188-232, sp.jl:358-469)
// ---------------------------------------------------------------------------

struct Carry {
  std::vector<double> z, v, zbar, vbar, z_old, v_old, dz, dvv, xi1, xi2, tmpz,
      tmpv;
};

static double inf_norm(const double *a, long n) {
  double m = 0;
  for (long i = 0; i < n; ++i) m = std::max(m, std::fabs(a[i]));
  return m;
}

}  // namespace

// shared C-ABI argument list + Problem construction for both solvers
#define SPOCK_ARGS \
    int N, int d, int nx, int nu, int ny, const double *A, const double *B, \
    const double *sqrtQ, const double *sqrtR, const double *sqrtQN, \
    const double *bvec, const double *ker, int risk_per_node, \
    const double *Kfac, const double *Rtinv, const double *ABK, \
    const double *PB, const double *x_min, const double *x_max, \
    const double *u_min, const double *u_max, const int32_t *cone_kinds, \
    const int32_t *cone_dims, int n_cones, int nc, const double *Gx, \
    const double *Gu, const double *plo, const double *phi, int ncL, \
    const double *GxN, const double *ploN, const double *phiN, \
    const double *x0, double gamma, double sigma, double tol, \
    long max_iter, double *z, double *v

namespace {
static Problem build_problem(
    int N, int d, int nx, int nu, int ny, const double *A, const double *B,
    const double *sqrtQ, const double *sqrtR, const double *sqrtQN,
    const double *bvec, const double *ker, int risk_per_node,
    const double *Kfac, const double *Rtinv, const double *ABK,
    const double *PB, const double *x_min, const double *x_max,
    const double *u_min, const double *u_max, const int32_t *cone_kinds,
    const int32_t *cone_dims, int n_cones, int nc, const double *Gx,
    const double *Gu, const double *plo, const double *phi, int ncL,
    const double *GxN, const double *ploN, const double *phiN) {
  Problem p;
  p.N = N; p.d = d; p.nx = nx; p.nu = nu; p.ny = ny;
  p.n = 1; { long pw = 1; for (int t = 1; t < N; ++t) { pw *= d; p.n += pw; } }
  p.n_leaf = 1; for (int t = 1; t < N; ++t) p.n_leaf *= d;
  p.n_nonleaf = p.n - p.n_leaf;
  p.A = A; p.B = B; p.sqrtQ = sqrtQ; p.sqrtR = sqrtR; p.sqrtQN = sqrtQN;
  p.bvec = bvec; p.ker = ker; p.risk_per_node = risk_per_node;
  p.K = Kfac; p.Rtinv = Rtinv; p.ABK = ABK; p.PB = PB;
  p.x_min = x_min; p.x_max = x_max; p.u_min = u_min; p.u_max = u_max;
  p.cone_kinds = cone_kinds; p.cone_dims = cone_dims; p.n_cones = n_cones;
  p.nc = nc; p.Gx = Gx; p.Gu = Gu; p.plo = plo; p.phi = phi;
  p.ncL = ncL; p.GxN = GxN; p.ploN = ploN; p.phiN = phiN;
  return p;
}
}  // namespace

#define SPOCK_BUILD_P \
  Problem p = build_problem(N, d, nx, nu, ny, A, B, sqrtQ, sqrtR, sqrtQN, \
      bvec, ker, risk_per_node, Kfac, Rtinv, ABK, PB, x_min, x_max, u_min, \
      u_max, cone_kinds, cone_dims, n_cones, nc, Gx, Gu, plo, phi, ncL, \
      GxN, ploN, phiN)

extern "C" {

// Solve with plain Chambolle-Pock.  z/v are warm-start in, solution out.
// Returns iterations used, or -1 - iters when not converged.
long spock_cpu_solve_cp(SPOCK_ARGS) {
  SPOCK_BUILD_P;

  ZOff zo = zoff(p);
  VOff vo = voff(p);
  const long nz = zo.nz, nv = vo.nv;
  Work w;
  w.q.resize(p.n * nx);
  w.dvec.resize(p.n_nonleaf * nu);

  std::vector<double> zbar(nz), vbar(nv), z_old(nz), v_old(nv), tz(nz), tv(nv),
      xi1(nz), xi2(nv);
  double res0_1 = -1, res0_2 = -1;  // -1 == unset

  long it = 0;
  for (; it < max_iter; ++it) {
    std::memcpy(z_old.data(), z, sizeof(double) * nz);
    std::memcpy(v_old.data(), v, sizeof(double) * nv);
    // zbar = prox_f(z - gamma L'v)
    apply_LT(p, v, tz.data());
    for (long k = 0; k < nz; ++k) zbar[k] = z[k] - gamma * tz[k];
    prox_f(p, zbar.data(), gamma, x0, w);
    // vbar = prox_h*(v + sigma L(2 zbar - z))
    for (long k = 0; k < nz; ++k) tz[k] = 2 * zbar[k] - z[k];
    apply_L(p, tz.data(), tv.data());
    for (long k = 0; k < nv; ++k) vbar[k] = v[k] + sigma * tv[k];
    prox_h_conj(p, vbar.data(), sigma, w);
    // relaxation lambda = 1
    std::memcpy(z, zbar.data(), sizeof(double) * nz);
    std::memcpy(v, vbar.data(), sizeof(double) * nv);
    // termination
    for (long k = 0; k < nz; ++k) tz[k] = z[k] - z_old[k];
    for (long k = 0; k < nv; ++k) tv[k] = v[k] - v_old[k];
    apply_LT(p, tv.data(), xi1.data());
    for (long k = 0; k < nz; ++k) xi1[k] -= tz[k] / gamma;
    apply_L(p, tz.data(), xi2.data());
    for (long k = 0; k < nv; ++k) xi2[k] -= tv[k] / sigma;
    double n1 = inf_norm(xi1.data(), nz), n2 = inf_norm(xi2.data(), nv);
    bool conv = n1 <= std::max(tol * (res0_1 < 0 ? -1e300 : res0_1), tol) &&
                n2 <= std::max(tol * (res0_2 < 0 ? -1e300 : res0_2), tol);
    if (res0_1 < 0) res0_1 = n1;
    if (res0_2 < 0) res0_2 = n2;
    if (conv) return it + 1;
  }
  return -1 - it;
}

// Solve with SuperMann-globalized CP + window-3 Anderson acceleration —
// the SPOCK algorithm (cf. sp.jl:358-469 and spock_tpu/algorithms/
// supermann.py; real geometric backtracking, K0 disabled).
long spock_cpu_solve_sp(SPOCK_ARGS) {
  SPOCK_BUILD_P;

  ZOff zo = zoff(p);
  VOff vo = voff(p);
  const long nz = zo.nz, nv = vo.nv, K = nz + nv;
  Work wk;
  wk.q.resize(p.n * nx);
  wk.dvec.resize(p.n_nonleaf * nu);

  const double c1 = 0.99, qpar = 0.99, sigma_k2 = 0.1, beta = 0.5;
  const int MAXBT = 8;
  const int M = 3;  // Anderson window

  std::vector<double> zbar(nz), vbar(nv), rz(nz), rv(nv), rz_prev(nz, 0.0),
      rv_prev(nv, 0.0), dzp(nz, 0.0), dvp(nv, 0.0), dz(nz), dv(nv), Mdz(nz),
      Mdv(nv), w(nz), u(nv), wbar(nz), ubar(nv), rw(nz), ru(nv), tz(nz),
      tv(nv), z_old(nz), v_old(nv), xi1(nz), xi2(nv);
  std::vector<double> MR(M * K, 0.0), MP(M * K, 0.0);
  double res0_1 = -1, res0_2 = -1, r_safe = 1e300, qpow = 1.0;

  auto sweep = [&](const double *zz, const double *vv, double *zb,
                   double *vb) {
    apply_LT(p, vv, tz.data());
    for (long k = 0; k < nz; ++k) zb[k] = zz[k] - gamma * tz[k];
    prox_f(p, zb, gamma, x0, wk);
    for (long k = 0; k < nz; ++k) tz[k] = 2 * zb[k] - zz[k];
    apply_L(p, tz.data(), tv.data());
    for (long k = 0; k < nv; ++k) vb[k] = vv[k] + sigma * tv[k];
    prox_h_conj(p, vb, sigma, wk);
  };
  // (mzO, mvO) = M (az, av)
  auto metric = [&](const double *az, const double *av, double *mz,
                    double *mv) {
    apply_LT(p, av, mz);
    for (long k = 0; k < nz; ++k) mz[k] = az[k] - gamma * mz[k];
    apply_L(p, az, mv);
    for (long k = 0; k < nv; ++k) mv[k] = av[k] - sigma * mv[k];
  };
  auto dot2 = [&](const double *a1, const double *a2, const double *b1,
                  const double *b2) {
    double s = 0;
    for (long k = 0; k < nz; ++k) s += a1[k] * b1[k];
    for (long k = 0; k < nv; ++k) s += a2[k] * b2[k];
    return s;
  };

  std::vector<double> mz(nz), mv(nv);
  long it = 0;
  for (; it < max_iter; ++it) {
    std::memcpy(z_old.data(), z, sizeof(double) * nz);
    std::memcpy(v_old.data(), v, sizeof(double) * nv);
    sweep(z, v, zbar.data(), vbar.data());
    for (long k = 0; k < nz; ++k) rz[k] = z[k] - zbar[k];
    for (long k = 0; k < nv; ++k) rv[k] = v[k] - vbar[k];
    metric(rz.data(), rv.data(), mz.data(), mv.data());
    double rnorm = std::sqrt(
        std::max(dot2(rz.data(), rv.data(), mz.data(), mv.data()), 0.0));

    // Anderson ring update: row slot = it % M; MR = dr, MP = dz - dr
    {
      int slot = (int)(it % M);
      double *mrow = MR.data() + (long)slot * K;
      double *prow = MP.data() + (long)slot * K;
      for (long k = 0; k < nz; ++k) {
        double dr = rz[k] - rz_prev[k];
        mrow[k] = dr;
        prow[k] = dzp[k] - dr;
      }
      for (long k = 0; k < nv; ++k) {
        double dr = rv[k] - rv_prev[k];
        mrow[nz + k] = dr;
        prow[nz + k] = dvp[k] - dr;
      }
    }
    // normal equations
    double G[M][M], c[M];
    for (int i = 0; i < M; ++i) {
      c[i] = 0;
      const double *ri = MR.data() + (long)i * K;
      for (long k = 0; k < nz; ++k) c[i] += ri[k] * rz[k];
      for (long k = 0; k < nv; ++k) c[i] += ri[nz + k] * rv[k];
      for (int j = i; j < M; ++j) {
        const double *rj = MR.data() + (long)j * K;
        double s = 0;
        for (long k = 0; k < K; ++k) s += ri[k] * rj[k];
        G[i][j] = G[j][i] = s;
      }
    }
    double trace = G[0][0] + G[1][1] + G[2][2];
    double eps = 1e-10 * trace / M + 1e-30;
    for (int i = 0; i < M; ++i) G[i][i] += eps;
    // solve 3x3 via Cramer-free Gaussian elimination
    double gma[M];
    {
      double a[M][M + 1];
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j < M; ++j) a[i][j] = G[i][j];
        a[i][M] = c[i];
      }
      for (int col = 0; col < M; ++col) {
        int piv = col;
        for (int r2 = col + 1; r2 < M; ++r2)
          if (std::fabs(a[r2][col]) > std::fabs(a[piv][col])) piv = r2;
        std::swap(a[piv], a[col]);
        double dgn = a[col][col];
        if (std::fabs(dgn) < 1e-300) dgn = 1e-300;
        for (int j = col; j <= M; ++j) a[col][j] /= dgn;
        for (int r2 = 0; r2 < M; ++r2)
          if (r2 != col) {
            double f = a[r2][col];
            for (int j = col; j <= M; ++j) a[r2][j] -= f * a[col][j];
          }
      }
      for (int i = 0; i < M; ++i) gma[i] = a[i][M];
    }
    for (long k = 0; k < nz; ++k) dz[k] = -rz[k];
    for (long k = 0; k < nv; ++k) dv[k] = -rv[k];
    for (int i = 0; i < M; ++i) {
      const double *prow = MP.data() + (long)i * K;
      const double gi = gma[i];
      for (long k = 0; k < nz; ++k) dz[k] -= gi * prow[k];
      for (long k = 0; k < nv; ++k) dv[k] -= gi * prow[nz + k];
    }
    metric(dz.data(), dv.data(), Mdz.data(), Mdv.data());

    // backtracking: fallback is plain CP (lambda = 1)
    bool accepted = false;
    double tau = 1.0;
    for (int bt = 0; bt <= MAXBT && !accepted; ++bt) {
      for (long k = 0; k < nz; ++k) w[k] = z[k] + tau * dz[k];
      for (long k = 0; k < nv; ++k) u[k] = v[k] + tau * dv[k];
      sweep(w.data(), u.data(), wbar.data(), ubar.data());
      for (long k = 0; k < nz; ++k) rw[k] = w[k] - wbar[k];
      for (long k = 0; k < nv; ++k) ru[k] = u[k] - ubar[k];
      metric(rw.data(), ru.data(), mz.data(), mv.data());
      double rt_sq =
          std::max(dot2(rw.data(), ru.data(), mz.data(), mv.data()), 0.0);
      double rtilde = std::sqrt(rt_sq);
      double rho =
          rt_sq - tau * dot2(rw.data(), ru.data(), Mdz.data(), Mdv.data());
      if (rnorm <= r_safe && rtilde <= c1 * rnorm) {  // K1
        std::memcpy(z, w.data(), sizeof(double) * nz);
        std::memcpy(v, u.data(), sizeof(double) * nv);
        r_safe = rtilde + qpow;
        accepted = true;
      } else if (rho >= sigma_k2 * rnorm * rtilde) {  // K2
        double coef = rt_sq > 0 ? rho / rt_sq : 0.0;
        for (long k = 0; k < nz; ++k) z[k] -= coef * rw[k];
        for (long k = 0; k < nv; ++k) v[k] -= coef * ru[k];
        accepted = true;
      } else {
        tau *= beta;
      }
    }
    if (!accepted) {
      std::memcpy(z, zbar.data(), sizeof(double) * nz);
      std::memcpy(v, vbar.data(), sizeof(double) * nv);
    }
    qpow *= qpar;

    // bookkeeping for the next iteration's secant pair
    std::memcpy(rz_prev.data(), rz.data(), sizeof(double) * nz);
    std::memcpy(rv_prev.data(), rv.data(), sizeof(double) * nv);
    for (long k = 0; k < nz; ++k) dzp[k] = z[k] - z_old[k];
    for (long k = 0; k < nv; ++k) dvp[k] = v[k] - v_old[k];

    // termination
    apply_LT(p, dvp.data(), xi1.data());
    for (long k = 0; k < nz; ++k) xi1[k] -= dzp[k] / gamma;
    apply_L(p, dzp.data(), xi2.data());
    for (long k = 0; k < nv; ++k) xi2[k] -= dvp[k] / sigma;
    double n1 = inf_norm(xi1.data(), nz), n2 = inf_norm(xi2.data(), nv);
    bool conv = n1 <= std::max(tol * (res0_1 < 0 ? -1e300 : res0_1), tol) &&
                n2 <= std::max(tol * (res0_2 < 0 ? -1e300 : res0_2), tol);
    if (res0_1 < 0) res0_1 = n1;
    if (res0_2 < 0) res0_2 = n2;
    if (conv) return it + 1;
  }
  return -1 - it;
}

}  // extern "C"
