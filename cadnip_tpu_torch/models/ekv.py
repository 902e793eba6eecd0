"""EKV 2.6-style compact MOSFET model, written in Verilog-A and compiled
through the port's VA compiler (a copy of `cadnip_tpu/models/ekv.py`; the
stand-in for the reference's VADistiller/PSP model packages until
PDK-grade models are imported).

The long-channel EKV core is smooth from weak to strong inversion
(no pnjlim needed): with the pinch-off voltage vp = (vg - vto)/n, the
normalized forward/reverse currents are F((vp - v)/vt) with
F(x) = ln(1 + exp(x/2))^2 and ID = 2 n beta vt^2 (i_f - i_r).
Charges use a simple charge-conserving gate-charge model with 50/50
drain/source partition plus overlap capacitances; noise is channel
thermal + 1/f.
"""
from __future__ import annotations

EKV_VA = r"""
// EKV 2.6-style long-channel MOSFET (public-equation compact model)
`include "disciplines.vams"

module ekv26(d, g, s, b);
  inout d, g, s, b;
  electrical d, g, s, b;

  parameter integer sign = 1;          // +1 NMOS, -1 PMOS
  parameter real vto   = 0.5;          // threshold [V]
  parameter real n     = 1.3;          // slope factor
  parameter real kp    = 200e-6;       // transconductance [A/V^2]
  parameter real lambda = 0.0;         // channel-length modulation [1/V]
  parameter real w     = 1e-6;
  parameter real l     = 1e-6;
  parameter real cox   = 3e-3;         // gate cap per area [F/m^2]
  parameter real cgso  = 1e-10;        // overlap caps per width [F/m]
  parameter real cgdo  = 1e-10;
  parameter real kf    = 0.0;          // flicker noise coefficient
  parameter real af    = 1.0;

  real vg, vd, vs, vt2, vp, beta, isq, xf, xr, i_f, i_r, ids;
  real qg, qch, vgt;
  (* desc="drain current", units="A" *) real id_op;
  (* desc="saturation voltage", units="V" *) real vdsat_op;

  analog begin
    vg = sign * V(g, b);
    vd = sign * V(d, b);
    vs = sign * V(s, b);
    vt2 = $vt;
    beta = kp * w / l;
    vp = (vg - vto) / n;
    // normalized currents: F(x) = ln(1+exp(x/2))^2, smooth all regions
    xf = ln(1.0 + limexp((vp - vs) / (2.0 * vt2)));
    xr = ln(1.0 + limexp((vp - vd) / (2.0 * vt2)));
    i_f = xf * xf;
    i_r = xr * xr;
    isq = 2.0 * n * beta * vt2 * vt2;
    ids = isq * (i_f - i_r) * (1.0 + lambda * abs(vd - vs));
    I(d, s) <+ sign * ids;

    // simple charge-conserving gate charge: inversion charge follows the
    // same smooth interpolation, split 50/50 between source and drain
    vgt = n * vt2 * (xf + xr);            // ~ (vg-vto-v_ch) smooth
    qch = -w * l * cox * vgt;             // inversion charge (per sign)
    qg  = -qch;
    I(g, b) <+ ddt(sign * qg);
    I(d, b) <+ ddt(sign * 0.5 * qch);
    I(s, b) <+ ddt(sign * 0.5 * qch);
    // overlap capacitances
    I(g, s) <+ ddt(cgso * w * V(g, s));
    I(g, d) <+ ddt(cgdo * w * V(g, d));

    // channel thermal noise (gamma=2/3 in saturation) + flicker
    I(d, s) <+ white_noise(8.0 / 3.0 * `P_K * $temperature
                           * sqrt(isq * beta * i_f) / n, "thermal");
    I(d, s) <+ flicker_noise(kf * pow(abs(ids), af) / (w * l * cox), 1.0);

    id_op = sign * ids;
    vdsat_op = 2.0 * vt2 * xf;
  end
endmodule
"""


def compile_ekv():
    """Compile the EKV module -> DeviceModel."""
    from ..va.codegen import compile_va
    return compile_va(EKV_VA)["ekv26"]
