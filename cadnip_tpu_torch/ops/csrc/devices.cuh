// Device models and source waveforms of kernel K2, one instance per thread.
//
// Each model's residual is written once, as a template over its number type
// (double, or Dual<NL> for f, q and the local Jacobians in one pass), and
// mirrors cadnip_tpu_torch/mna/devices.py operation for operation: the
// twin's evaluation is `mna/assemble.py::_group_eval` on those functions.
// The limiters act on plain doubles, as the twin's do (outside autodiff).
// Waveforms mirror cadnip_tpu_torch/mna/waveforms.py::eval_wave.
//
// Parameters arrive as one row per instance, in the order that
// cadnip_tpu_torch/ops/vmem_tran.py::KERNEL_MODELS lists for the model;
// the P_* indices below must match it. A library built for a circuit with
// Verilog-A models (CADNIP_VA_MODELS) adds their emitted structs
// (va/cuda.py), each row in the order the emitter gives.
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

namespace dev {

constexpr double KB = 1.380649e-23;
constexpr double QE = 1.602176634e-19;
constexpr double PI2 = 6.283185307179586;     // 2 * math.pi
constexpr double SQRT2 = 1.4142135623730951;  // math.sqrt(2.0)

enum Model { RESISTOR = 0, CAPACITOR = 1, VSOURCE = 2, ISOURCE = 3,
             DIODE = 4, DIODE_RS = 5, MOS1 = 6, INDUCTOR = 7, MUTUAL = 8,
             VCVS = 9, VCCS = 10, CCCS = 11, CCVS = 12, BJT = 13 };

// the most local unknowns of one instance (the VCVS's five)
constexpr int MAX_NL = 5;

// parameter rows (KERNEL_MODELS in ops/vmem_tran.py)
enum { P_R = 0 };       // resistor; the CCVS's transresistance
enum { P_C = 0 };
enum { P_L = 0 };
enum { P_M = 0 };
enum { P_GAIN = 0 };    // VCVS, CCCS
enum { P_GM = 0 };
enum { Q_TYPE = 0, Q_IS, Q_BF, Q_BR, Q_NF, Q_NR, Q_VAF, Q_VAR, Q_CJE, Q_VJE,
       Q_MJE, Q_CJC, Q_VJC, Q_MJC, Q_TF, Q_TR, Q_FC, Q_AREA };
enum { D_IS = 0, D_N, D_CJO, D_VJ, D_M, D_FC, D_TT, D_BV, D_IBV, D_AREA,
       D_RS };
enum { M_TYPE = 0, M_VTH, M_KP, M_LAMBDA, M_W, M_L, M_CGS, M_CGD, M_CGB,
       M_CBD, M_CBS, M_IS };

struct Dyn {
  double temp, gmin, srcfact;
  double vt;   // KB * temp / QE, as DynSpec.vt
};

__host__ __device__ __forceinline__ Dyn make_dyn(double temp, double gmin,
                                        double srcfact) {
  Dyn d;
  d.temp = temp;
  d.gmin = gmin;
  d.srcfact = srcfact;
  d.vt = KB * temp / QE;
  return d;
}

// torch.maximum / torch.minimum on doubles: NaN propagates
__device__ __forceinline__ double tmax(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}

// ---------------------------------------------------------------------------
// limiters (devices.py: pnjlim, fetlim, limvds)

__device__ __forceinline__ double pnjlim(double vnew, double vold, double vt,
                                         double vcrit) {
  const bool big = (vnew > vcrit) && (fabs(vnew - vold) > 2.0 * vt);
  const double arg = 1.0 + (vnew - vold) / vt;
  const double v_pos = arg > 0.0 ? vold + vt * log(clamp_min(arg, 1e-300))
                                 : vcrit;
  const double v_neg = vt * log(clamp_min(vnew / vt, 1e-300));
  const double vlim = vold > 0.0 ? v_pos : v_neg;
  return big ? vlim : vnew;
}

__device__ __forceinline__ double fetlim(double vnew, double vold,
                                         double vto) {
  const double vtsthi = fabs(2.0 * (vold - vto)) + 2.0;
  const double vtstlo = fabs(vold - vto) + 1.0;
  const double vtox = vto + 3.5;
  const double delv = vnew - vold;
  const double on_dec = vnew >= vtox ? (-delv > vtstlo ? vold - vtstlo : vnew)
                                     : tmax(vnew, vto + 2.0);
  const double on_inc = delv >= vtsthi ? vold + vtsthi : vnew;
  const double on = delv <= 0.0 ? on_dec : on_inc;
  const double mid = delv <= 0.0 ? tmax(vnew, vto - 0.5)
                                 : tmin(vnew, vto + 4.0);
  const double off_dec = -delv > vtsthi ? vold - vtsthi : vnew;
  const double off_inc = vnew <= vto + 0.5
                             ? (delv > vtstlo ? vold + vtstlo : vnew)
                             : vto + 0.5;
  const double off = delv <= 0.0 ? off_dec : off_inc;
  return vold >= vto ? (vold >= vtox ? on : mid) : off;
}

__device__ __forceinline__ double limvds(double vnew, double vold) {
  const double hi = vnew > vold ? tmin(vnew, 3.0 * vold + 2.0)
                                : (vnew < 3.5 ? clamp_min(vnew, 2.0) : vnew);
  const double lo = vnew > vold ? clamp_max(vnew, 4.0)
                                : clamp_min(vnew, -0.5);
  return vold >= 3.5 ? hi : lo;
}

// ---------------------------------------------------------------------------
// models: residual(u, p, v_src, dyn, f, q) and limit(u, u_prev, p, dyn, ue)

template <typename T>
__device__ __forceinline__ T powx(const T& x, double e) {
  return dexp(e * dlog(clamp_min(x, 1e-30)));
}

struct Resistor {
  static constexpr int NL = 2;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const double g = 1.0 / p[P_R];
    const T i = g * (u[0] - u[1]);
    f[0] = i;
    f[1] = -i;
    q[0] = T(0.0);
    q[1] = T(0.0);
  }
};

struct Capacitor {
  static constexpr int NL = 2;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T qc = p[P_C] * (u[0] - u[1]);
    f[0] = T(0.0);
    f[1] = T(0.0);
    q[0] = qc;
    q[1] = -qc;
  }
};

struct VSource {
  static constexpr int NL = 3;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double*, double v,
                                  const Dyn& d, T* f, T* q) {
    const double vs = v * d.srcfact;
    f[0] = u[2];
    f[1] = -u[2];
    f[2] = u[0] - u[1] - vs;
    for (int a = 0; a < 3; ++a) q[a] = T(0.0);
  }
};

struct ISource {
  static constexpr int NL = 2;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T*, const double*, double v,
                                  const Dyn& d, T* f, T* q) {
    const double i = v * d.srcfact;
    f[0] = T(i);
    f[1] = T(-i);
    q[0] = T(0.0);
    q[1] = T(0.0);
  }
};

// junction current and charge of the level-1 diode (devices.py _diode_ivq)
template <typename T>
__device__ void diode_ivq(const T& vd, const double* p, const Dyn& dy, T& i,
                          T& q) {
  const double vt = p[D_N] * dy.vt;
  const double is_ = p[D_IS] * p[D_AREA];
  const T x = clip(vd / vt, -80.0, 80.0);
  const T idf = is_ * (dexp(x) - 1.0);
  const double bv = p[D_BV];
  const T xb = clip(-(vd + bv) / dy.vt, -80.0, 80.0);
  const T ibr = bv > 0.0 ? -p[D_IBV] * dexp(xb) : 0.0 * xb;
  i = idf + ibr + dy.gmin * vd;
  const double cj0 = p[D_CJO] * p[D_AREA], vj = p[D_VJ], m = p[D_M],
               fc = p[D_FC];
  const double fcv = fc * vj;
  T qj;
  if (val(vd) < fcv) {
    // minimum(vd, fcv) is vd on this branch
    qj = cj0 * vj / (1.0 - m)
         * (1.0 - powx(clamp_min(1.0 - vd / vj, 1e-6), 1.0 - m));
  } else {
    const double f1 = cj0 * vj / (1.0 - m)
                      * (1.0 - powx(1.0 - fc, 1.0 - m));
    const double f2 = powx(1.0 - fc, -1.0 - m);
    qj = f1 + cj0 * f2 * ((1.0 - fc * (1.0 + m)) * (vd - fcv)
                          + 0.5 * m / vj * (vd * vd - fcv * fcv));
  }
  q = qj + p[D_TT] * idf;
}

__device__ __forceinline__ double diode_vcrit(const double* p,
                                              const Dyn& dy) {
  const double vt = p[D_N] * dy.vt;
  return vt * log(vt / (SQRT2 * clamp_min(p[D_IS] * p[D_AREA], 1e-300)));
}

struct Diode {
  static constexpr int NL = 2;
  static constexpr bool LIMITED = true;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn& d, T* f, T* q) {
    T i, qq;
    diode_ivq(u[0] - u[1], p, d, i, qq);
    f[0] = i;
    f[1] = -i;
    q[0] = qq;
    q[1] = -qq;
  }
  __device__ static void limit(const double* u, const double* up,
                               const double* p, const Dyn& d, double* ue) {
    const double vd = pnjlim(u[0] - u[1], up[0] - up[1], p[D_N] * d.vt,
                             diode_vcrit(p, d));
    ue[0] = u[1] + vd;
    ue[1] = u[1];
  }
};

struct DiodeRs {
  static constexpr int NL = 3;
  static constexpr bool LIMITED = true;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn& d, T* f, T* q) {
    const double g = 1.0 / clamp_min(p[D_RS], 1e-12);
    const T ir = g * (u[0] - u[2]);
    T i, qq;
    diode_ivq(u[2] - u[1], p, d, i, qq);
    f[0] = ir;
    f[1] = -i;
    f[2] = i - ir;
    q[0] = 0.0 * qq;
    q[1] = -qq;
    q[2] = qq;
  }
  __device__ static void limit(const double* u, const double* up,
                               const double* p, const Dyn& d, double* ue) {
    const double vd = pnjlim(u[2] - u[1], up[2] - up[1], p[D_N] * d.vt,
                             diode_vcrit(p, d));
    ue[0] = u[0];
    ue[1] = u[1];
    ue[2] = u[1] + vd;
  }
};

// overflow-safe exp with linear continuation above x = 80
template <typename T>
__device__ __forceinline__ T limexp_dev(const T& x) {
  return dexp(clamp_max(x, 80.0)) * (1.0 + clamp_min(x - 80.0, 0.0));
}

template <typename T>
__device__ T mos1_ids(const T& vgs, const T& vds, const double* p,
                      double vth) {
  const double beta = p[M_KP] * p[M_W] / p[M_L];
  const T vov = vgs - vth;
  const T clm = 1.0 + p[M_LAMBDA] * vds;
  const T i_sat = 0.5 * beta * vov * vov * clm;
  const T i_tri = beta * (vov - 0.5 * vds) * vds * clm;
  const T i_on = val(vds) > val(vov) ? i_sat : i_tri;
  return val(vov) <= 0.0 ? 0.0 * i_on : i_on;
}

struct Mos1 {
  static constexpr int NL = 4;
  static constexpr bool LIMITED = true;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn& dy, T* f, T* q) {
    const double ty = p[M_TYPE];
    const T vd = ty * u[0], vg = ty * u[1], vs = ty * u[2], vb = ty * u[3];
    const bool fwd = val(vd) >= val(vs);
    const T vgs = fwd ? vg - vs : vg - vd;
    const T vds = dabs(vd - vs);
    const double sgn = fwd ? 1.0 : -1.0;
    T ids = mos1_ids(vgs, vds, p, ty * p[M_VTH]) * sgn * ty;
    ids = ids + dy.gmin * (u[0] - u[2]);
    const double vt = dy.vt;
    const double isat = p[M_IS];
    const T ibd = isat * (limexp_dev((vb - vd) / vt) - 1.0)
                  + dy.gmin * (vb - vd);
    const T ibs = isat * (limexp_dev((vb - vs) / vt) - 1.0)
                  + dy.gmin * (vb - vs);
    f[0] = ids - ty * ibd;
    f[1] = 0.0 * ids;
    f[2] = -ids - ty * ibs;
    f[3] = ty * (ibd + ibs);
    const T qgs = p[M_CGS] * (u[1] - u[2]);
    const T qgd = p[M_CGD] * (u[1] - u[0]);
    const T qgb = p[M_CGB] * (u[1] - u[3]);
    const T qbd = p[M_CBD] * (u[3] - u[0]);
    const T qbs = p[M_CBS] * (u[3] - u[2]);
    q[0] = -qgd - qbd;
    q[1] = qgs + qgd + qgb;
    q[2] = -qgs - qbs;
    q[3] = -qgb + qbd + qbs;
  }
  // fetlim on the oriented gate overdrive, limvds on the drain-source step,
  // then pnjlim on the bulk junctions (ngspice MOS1load order)
  __device__ static void limit(const double* u, const double* up,
                               const double* p, const Dyn& dy, double* ue) {
    const double ty = p[M_TYPE];
    const double vd = ty * u[0], vg = ty * u[1], vs = ty * u[2],
                 vb = ty * u[3];
    const double vdp = ty * up[0], vgp = ty * up[1], vsp = ty * up[2];
    const double vto = ty * p[M_VTH];
    const bool fwd = vd >= vs;
    const double src = fwd ? vs : vd;
    const double src_p = fwd ? vsp : vdp;
    const double vgs_l = fetlim(vg - src, vgp - src_p, vto);
    const double vds_l = limvds(fabs(vd - vs), fabs(vdp - vsp));
    const double vg2 = src + vgs_l;
    const double vdrain2 = src + vds_l;
    const double vd2 = fwd ? vdrain2 : vd;
    const double vs2 = fwd ? vs : vdrain2;
    const double vbp = ty * up[3];
    const double vt = dy.vt;
    const double vcrit = vt * log(vt / (1.41421356 * p[M_IS]));
    const double vbd_l = pnjlim(vb - vd2, vbp - ty * up[0], vt, vcrit);
    const double vbs_l = pnjlim(vb - vs2, vbp - ty * up[2], vt, vcrit);
    ue[0] = ty * (vb - vbd_l);
    ue[1] = ty * vg2;
    ue[2] = ty * (vb - vbs_l);
    ue[3] = ty * vb;
  }
};

struct Inductor {
  static constexpr int NL = 3;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T& i = u[2];
    f[0] = i;
    f[1] = -i;
    f[2] = u[0] - u[1];
    q[0] = 0.0 * i;
    q[1] = 0.0 * i;
    q[2] = -p[P_L] * i;
  }
};

// u = [i1, i2], the sensed inductor currents: -M i_other on each flux row
struct Mutual {
  static constexpr int NL = 2;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const double m = p[P_M];
    f[0] = T(0.0);
    f[1] = T(0.0);
    q[0] = -m * u[1];
    q[1] = -m * u[0];
  }
};

struct Vcvs {
  static constexpr int NL = 5;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T& i = u[4];
    f[0] = i;
    f[1] = -i;
    f[2] = 0.0 * i;
    f[3] = 0.0 * i;
    f[4] = u[0] - u[1] - p[P_GAIN] * (u[2] - u[3]);
    for (int a = 0; a < 5; ++a) q[a] = T(0.0);
  }
};

struct Vccs {
  static constexpr int NL = 4;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T i = p[P_GM] * (u[2] - u[3]);
    f[0] = i;
    f[1] = -i;
    f[2] = 0.0 * i;
    f[3] = 0.0 * i;
    for (int a = 0; a < 4; ++a) q[a] = T(0.0);
  }
};

// u = [vp, vn, i_sense]: the sensed branch current is read, not stamped
struct Cccs {
  static constexpr int NL = 3;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T i = p[P_GAIN] * u[2];
    f[0] = i;
    f[1] = -i;
    f[2] = 0.0 * u[2];
    for (int a = 0; a < 3; ++a) q[a] = T(0.0);
  }
};

// u = [vp, vn, i_sense, i]
struct Ccvs {
  static constexpr int NL = 4;
  static constexpr bool LIMITED = false;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn&, T* f, T* q) {
    const T& i = u[3];
    f[0] = i;
    f[1] = -i;
    f[2] = 0.0 * i;
    f[3] = u[0] - u[1] - p[P_R] * u[2];
    for (int a = 0; a < 4; ++a) q[a] = T(0.0);
  }
};

// depletion charge with the fc linearization (devices.py _junction_q)
template <typename T>
__device__ T junction_q(const T& v, double cj0, double vj, double m,
                        double fc) {
  const double fcv = fc * vj;
  if (val(v) < fcv) {
    // minimum(v, fcv) is v on this branch
    return cj0 * vj / (1.0 - m)
           * (1.0 - powx(clamp_min(1.0 - v / vj, 1e-6), 1.0 - m));
  }
  const double f1 = cj0 * vj / (1.0 - m) * (1.0 - powx(1.0 - fc, 1.0 - m));
  const double f2 = powx(1.0 - fc, -1.0 - m);
  return f1 + cj0 * f2 * ((1.0 - fc * (1.0 + m)) * (v - fcv)
                          + 0.5 * m / vj * (v * v - fcv * fcv));
}

// Ebers-Moll transport currents with the Early factor (devices.py
// _bjt_currents); exp arguments clipped to +-80
template <typename T>
__device__ void bjt_currents(const T& vbe, const T& vbc, const double* p,
                             const Dyn& dy, T& ic, T& ib, T& ie, T& icc,
                             T& iec) {
  const double vt = dy.vt;
  const double is_ = p[Q_IS] * p[Q_AREA];
  const T ex_be = dexp(clip(vbe / (p[Q_NF] * vt), -80.0, 80.0));
  const T ex_bc = dexp(clip(vbc / (p[Q_NR] * vt), -80.0, 80.0));
  icc = is_ * (ex_be - 1.0);
  iec = is_ * (ex_bc - 1.0);
  const T qb_inv = 1.0 - vbc / p[Q_VAF] - vbe / p[Q_VAR];
  const T qb = 1.0 / clamp_min(qb_inv, 0.1);
  const T it = (icc - iec) / qb;
  ib = icc / p[Q_BF] + iec / p[Q_BR];
  ic = it - iec / p[Q_BR];
  ie = -(it + icc / p[Q_BF]);
}

// u = [vc, vb, ve]; `type` is +1 npn, -1 pnp
struct Bjt {
  static constexpr int NL = 3;
  static constexpr bool LIMITED = true;
  template <typename T>
  __device__ static void residual(const T* u, const double* p, double,
                                  const Dyn& dy, T* f, T* q) {
    const double ty = p[Q_TYPE];
    const T vc = ty * u[0], vb = ty * u[1], ve = ty * u[2];
    const T vbe = vb - ve;
    const T vbc = vb - vc;
    T ic, ib, ie, icc, iec;
    bjt_currents(vbe, vbc, p, dy, ic, ib, ie, icc, iec);
    const double gm = dy.gmin;
    f[0] = ty * (ic + gm * (vc - vb));
    f[1] = ty * (ib - gm * (vc - vb) - gm * (ve - vb));
    f[2] = ty * (ie + gm * (ve - vb));
    const T qbe = junction_q(vbe, p[Q_CJE] * p[Q_AREA], p[Q_VJE], p[Q_MJE],
                             p[Q_FC]) + p[Q_TF] * icc;
    const T qbc = junction_q(vbc, p[Q_CJC] * p[Q_AREA], p[Q_VJC], p[Q_MJC],
                             p[Q_FC]) + p[Q_TR] * iec;
    q[0] = -ty * qbc;
    q[1] = ty * (qbe + qbc);
    q[2] = -ty * qbe;
  }
  // pnjlim on both junctions; the base stays, emitter and collector move
  __device__ static void limit(const double* u, const double* up,
                               const double* p, const Dyn& dy, double* ue) {
    const double ty = p[Q_TYPE];
    const double vt = dy.vt;
    const double is_ = p[Q_IS] * p[Q_AREA];
    const double vcrit = vt * log(vt / (SQRT2 * clamp_min(is_, 1e-300)));
    const double vbe = pnjlim(ty * (u[1] - u[2]), ty * (up[1] - up[2]), vt,
                              vcrit);
    const double vbc = pnjlim(ty * (u[1] - u[0]), ty * (up[1] - up[0]), vt,
                              vcrit);
    ue[0] = u[1] - ty * vbc;
    ue[1] = u[1];
    ue[2] = u[1] - ty * vbe;
  }
};

// One instance: limit (when the model has a limiter), then the residual on
// Dual<NL> at the limited point, linearized back to u as the twin does:
// f + J (u - u_eval), q + C (u - u_eval). Outputs f, q, u_eval [NL] and
// J, C [NL][NL] (row = residual entry, column = unknown).
template <class M>
__device__ void eval_instance(const double* u, const double* up,
                              const double* p, double v_src, const Dyn& d,
                              double* f, double* q, double* J, double* C,
                              double* ue) {
  constexpr int NL = M::NL;
  double uev[NL];
  if constexpr (M::LIMITED) {
    M::limit(u, up, p, d, uev);
  } else {
#pragma unroll
    for (int a = 0; a < NL; ++a) uev[a] = u[a];
  }
  Dual<NL> ud[NL], fd[NL], qd[NL];
#pragma unroll
  for (int a = 0; a < NL; ++a) ud[a] = Dual<NL>::var(uev[a], a);
  M::residual(ud, p, v_src, d, fd, qd);
#pragma unroll
  for (int a = 0; a < NL; ++a) {
    double fa = 0.0, qa = 0.0;
#pragma unroll
    for (int b = 0; b < NL; ++b) {
      const double du = u[b] - uev[b];
      fa += fd[a].d[b] * du;
      qa += qd[a].d[b] * du;
      J[a * NL + b] = fd[a].d[b];
      C[a * NL + b] = qd[a].d[b];
    }
    f[a] = fd[a].v + fa;
    q[a] = qd[a].v + qa;
    ue[a] = uev[a];
  }
}

}  // namespace dev

#ifdef CADNIP_VA_MODELS
// The Verilog-A models of this library (va/cuda.py writes the header beside
// the build): structs of the form above, with ids from 14 on, and their
// dispatch va_eval_model.
#include "va_models.cuh"
#endif

namespace dev {

// dispatch on the model id; returns false for an unknown id
__device__ __forceinline__ bool eval_model(int model, const double* u,
                                           const double* up, const double* p,
                                           double v_src, const Dyn& d,
                                           double* f, double* q, double* J,
                                           double* C, double* ue) {
  switch (model) {
    case RESISTOR: eval_instance<Resistor>(u, up, p, v_src, d, f, q, J, C,
                                           ue); return true;
    case CAPACITOR: eval_instance<Capacitor>(u, up, p, v_src, d, f, q, J, C,
                                             ue); return true;
    case VSOURCE: eval_instance<VSource>(u, up, p, v_src, d, f, q, J, C,
                                         ue); return true;
    case ISOURCE: eval_instance<ISource>(u, up, p, v_src, d, f, q, J, C,
                                         ue); return true;
    case DIODE: eval_instance<Diode>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case DIODE_RS: eval_instance<DiodeRs>(u, up, p, v_src, d, f, q, J, C,
                                          ue); return true;
    case MOS1: eval_instance<Mos1>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case INDUCTOR: eval_instance<Inductor>(u, up, p, v_src, d, f, q, J, C,
                                           ue); return true;
    case MUTUAL: eval_instance<Mutual>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case VCVS: eval_instance<Vcvs>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case VCCS: eval_instance<Vccs>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case CCCS: eval_instance<Cccs>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case CCVS: eval_instance<Ccvs>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
    case BJT: eval_instance<Bjt>(u, up, p, v_src, d, f, q, J, C, ue);
      return true;
#ifdef CADNIP_VA_MODELS
    default: return va_eval_model(model, u, up, p, v_src, d, f, q, J, C, ue);
#else
    default: return false;
#endif
  }
}

// ---------------------------------------------------------------------------
// waveforms (waveforms.py eval_wave); c holds W coefficients

enum Wave { WAVE_DC = 0, WAVE_PULSE = 1, WAVE_SIN = 2, WAVE_PWL = 3,
            WAVE_EXP = 4, WAVE_SFFM = 5 };

// torch.remainder: floored modulo, the sign of the divisor
__device__ __forceinline__ double remainder_f(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m += b;
  return m;
}

__device__ double eval_wave(long long kind, const double* c, int W,
                            double t) {
  switch (kind) {
    case WAVE_PULSE: {
      const double v1 = c[0], v2 = c[1], td = c[2];
      const double tr = clamp_min(c[3], 1e-15), tf = clamp_min(c[4], 1e-15);
      const double pw = c[5], per = clamp_min(c[6], 1e-15);
      const double tl = t < td ? -1.0 : remainder_f(t - td, per);
      const double up = v1 + (v2 - v1) * clip(tl / tr, 0.0, 1.0);
      const double dn = v2 + (v1 - v2) * clip((tl - tr - pw) / tf, 0.0, 1.0);
      const double v = tl < tr + pw ? up : dn;
      return tl < 0.0 ? v1 : v;
    }
    case WAVE_SIN: {
      const double vo = c[0], va = c[1], fr = c[2], td = c[3], th = c[4],
                   ph = c[5];
      const double tl = t - td;
      const double ramp = vo + va * sin(PI2 * ph / 360.0);
      const double wave = vo + va * exp(-tl * th)
                                   * sin(PI2 * (fr * tl + ph / 360.0));
      return tl < 0.0 ? ramp : wave;
    }
    case WAVE_PWL: {
      // jnp.interp with flat extrapolation over (t_k, v_k) = c[2k], c[2k+1]
      const int m = W / 2;
      const double x = t + 0.0 * c[0];
      // searchsorted(right=True): the first t_k > x, which over sorted t_k
      // is the count of t_k not above x (independent loads, no chain)
      int i = 0;
      for (int k = 0; k < m; ++k) i += !(c[2 * k] > x);
      i = i < 1 ? 1 : (i > m - 1 ? m - 1 : i);
      const double t_hi = c[2 * i], t_lo = c[2 * i - 2];
      const double v_hi = c[2 * i + 1], v_lo = c[2 * i - 1];
      const double dx = t_hi - t_lo;
      const bool dx0 = fabs(dx) <= 4.930380657631324e-32;
      double f = dx0 ? v_lo : v_lo + ((x - t_lo) / dx) * (v_hi - v_lo);
      if (x < c[0]) f = c[1];
      if (x > c[2 * (m - 1)]) f = c[2 * (m - 1) + 1];
      return f;
    }
    case WAVE_EXP: {
      const double v1 = c[0], v2 = c[1], td1 = c[2], td2 = c[4];
      const double tau1 = clamp_min(c[3], 1e-15), tau2 = clamp_min(c[5],
                                                                    1e-15);
      const double rise = (v2 - v1) * (1.0 - exp(-clamp_min(t - td1, 0.0)
                                                 / tau1));
      const double fall = (v1 - v2) * (1.0 - exp(-clamp_min(t - td2, 0.0)
                                                 / tau2));
      return v1 + (t > td1 ? rise : 0.0) + (t > td2 ? fall : 0.0);
    }
    case WAVE_SFFM: {
      const double vo = c[0], va = c[1], fc = c[2], mdi = c[3], fs = c[4];
      return vo + va * sin(PI2 * fc * t + mdi * sin(PI2 * fs * t));
    }
    default:   // WAVE_DC
      return c[0] + 0.0 * t;
  }
}

}  // namespace dev
