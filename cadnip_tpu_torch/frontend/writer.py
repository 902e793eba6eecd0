"""Netlist writers: Circuit -> SPICE text (and, combined with the parsers,
dialect conversion Spectre -> SPICE etc. — the core of what the reference's
SpiceArmyKnife `spak-convert` does, SURVEY §2.8)."""
from __future__ import annotations

from ..mna import devices as dv
from ..mna import waveforms as wf
from ..mna.structure import Circuit


def _fmt(v: float) -> str:
    return f"{v:.12g}"


def _wave_str(w) -> str:
    if w is None or w.kind == wf.WAVE_DC:
        return ""
    c = w.coeffs
    if w.kind == wf.WAVE_PULSE:
        return "PULSE(" + " ".join(_fmt(x) for x in c) + ")"
    if w.kind == wf.WAVE_SIN:
        return "SIN(" + " ".join(_fmt(x) for x in c) + ")"
    if w.kind == wf.WAVE_PWL:
        return "PWL(" + " ".join(_fmt(x) for x in c) + ")"
    if w.kind == wf.WAVE_EXP:
        return "EXP(" + " ".join(_fmt(x) for x in c) + ")"
    if w.kind == wf.WAVE_SFFM:
        return "SFFM(" + " ".join(_fmt(x) for x in c) + ")"
    return ""


def to_spice(cir: Circuit) -> str:
    """Serialize a Circuit to SPICE netlist text. Built-in devices emit
    native SPICE cards; VA/behavioral devices emit N-cards with inline
    parameter overrides (round-trippable through our own parser)."""
    lines = [cir.title or "converted netlist"]
    model_cards = {}
    for inst in cir.instances:
        m = inst.model
        nm = inst.name
        nd = list(inst.nodes)
        p = inst.params
        if m is dv.RESISTOR:
            lines.append(f"{_r(nm, 'r')} {nd[0]} {nd[1]} "
                         f"{_fmt(p.get('r', 1e3))}")
        elif m is dv.CAPACITOR:
            lines.append(f"{_r(nm, 'c')} {nd[0]} {nd[1]} "
                         f"{_fmt(p.get('c', 1e-12))}")
        elif m is dv.INDUCTOR:
            lines.append(f"{_r(nm, 'l')} {nd[0]} {nd[1]} "
                         f"{_fmt(p.get('l', 1e-9))}")
        elif m in (dv.VSOURCE, dv.ISOURCE):
            letter = "v" if m is dv.VSOURCE else "i"
            parts = [f"{_r(nm, letter)} {nd[0]} {nd[1]}",
                     f"dc {_fmt(inst.wave.dc if inst.wave else 0.0)}"]
            if p.get("acmag"):
                parts.append(f"ac {_fmt(p['acmag'])} "
                             f"{_fmt(p.get('acphase', 0.0))}")
            ws = _wave_str(inst.wave)
            if ws:
                parts.append(ws)
            lines.append(" ".join(parts))
        elif m is dv.VCVS:
            lines.append(f"{_r(nm, 'e')} {' '.join(nd)} "
                         f"{_fmt(p.get('gain', 1.0))}")
        elif m is dv.VCCS:
            lines.append(f"{_r(nm, 'g')} {' '.join(nd)} "
                         f"{_fmt(p.get('gm', 1.0))}")
        elif m is dv.CCCS:
            lines.append(f"{_r(nm, 'f')} {' '.join(nd)} {inst.sense[0]} "
                         f"{_fmt(p.get('gain', 1.0))}")
        elif m is dv.CCVS:
            lines.append(f"{_r(nm, 'h')} {' '.join(nd)} {inst.sense[0]} "
                         f"{_fmt(p.get('r', 1.0))}")
        elif m is dv.MUTUAL:
            lines.append(f"{_r(nm, 'k')} {inst.sense[0]} {inst.sense[1]} "
                         f"{_fmt(p.get('m', 0.0))}")
        elif m in (dv.DIODE, dv.DIODE_RS):
            mdl = _model_for(model_cards, m, "d", p,
                             skip={"area"})
            area = p.get("area", 1.0)
            lines.append(f"{_r(nm, 'd')} {nd[0]} {nd[1]} {mdl}"
                         + (f" area={_fmt(area)}" if area != 1.0 else ""))
        elif m is dv.BJT:
            mtype = "pnp" if p.get("type", 1.0) < 0 else "npn"
            mdl = _model_for(model_cards, m, mtype, p,
                             skip={"type", "area"})
            lines.append(f"{_r(nm, 'q')} {' '.join(nd)} {mdl}")
        elif m is dv.MOSFET1:
            mtype = "pmos" if p.get("type", 1.0) < 0 else "nmos"
            mdl = _model_for(model_cards, m, mtype, p,
                             skip={"type", "w", "l"})
            lines.append(f"{_r(nm, 'm')} {' '.join(nd)} {mdl} "
                         f"w={_fmt(p.get('w', m.defaults['w']))} "
                         f"l={_fmt(p.get('l', m.defaults['l']))}")
        else:
            # VA / behavioral: N-card with inline params
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in p.items()
                          if not str(k).endswith("__given"))
            lines.append(f"n{nm} {' '.join(nd)} {m.name} {kv}".strip())
    # model cards
    rev = {"vth": "vto", "cgs": "cgso", "cgd": "cgdo", "cgb": "cgbo",
           "cjo": "cjo"}
    for (mdl_name, mtype, items) in model_cards.values():
        kv = " ".join(f"{rev.get(k, k)}={_fmt(v)}" for k, v in items)
        lines.append(f".model {mdl_name} {mtype} ({kv})")
    lines.append(".end")
    return "\n".join(lines) + "\n"


def _r(name: str, letter: str) -> str:
    """Instance name with the right leading letter."""
    return name if name.lower().startswith(letter) else letter + name


def _model_for(cards: dict, model, mtype: str, params: dict, skip=()):
    items = tuple(sorted((k, float(v)) for k, v in params.items()
                         if k not in skip and
                         float(v) != float(model.defaults.get(k, v))))
    key = (mtype, items)
    if key not in cards:
        cards[key] = (f"m{mtype}{len(cards)}", mtype, items)
    return cards[key][0]


def _spectre_wave_params(w) -> str:
    """Spectre vsource/isource waveform parameter string (the VACASK
    dialect the reference's `cg_spectre.jl` targets, SURVEY §2.8)."""
    if w is None or w.kind == wf.WAVE_DC:
        return f"dc={_fmt(w.dc if w is not None else 0.0)}"
    c = w.coeffs
    if w.kind == wf.WAVE_PULSE:
        keys = ("val0", "val1", "delay", "rise", "fall", "width", "period")
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in zip(keys, c))
        return f"type=pulse dc={_fmt(c[0])} {kv}"
    if w.kind == wf.WAVE_SIN:
        return (f"type=sine sinedc={_fmt(c[0])} ampl={_fmt(c[1])} "
                f"freq={_fmt(c[2])}"
                + (f" delay={_fmt(c[3])}" if len(c) > 3 and c[3] else ""))
    if w.kind == wf.WAVE_PWL:
        pts = " ".join(_fmt(x) for x in c)
        return f"type=pwl wave=[{pts}]"
    if w.kind == wf.WAVE_EXP:
        keys = ("val0", "val1", "td1", "tau1", "td2", "tau2")
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in zip(keys, c))
        return f"type=exp dc={_fmt(c[0])} {kv}"
    return f"dc={_fmt(w.dc)}"


def to_spectre(cir: Circuit) -> str:
    """Serialize a Circuit to Spectre netlist text (the reference
    SpiceArmyKnife's `cg_spectre.jl` backend / VACASK target,
    `SpiceArmyKnife.jl/src/cg_spectre.jl`, SURVEY §2.8). Built-in
    devices map onto Spectre primitives; diode/BJT/MOS emit shared
    `model` cards; VA devices instance their module name directly."""
    lines = [f"// {cir.title or 'converted netlist'}",
             "simulator lang=spectre"]
    model_cards = {}
    body = []
    for inst in cir.instances:
        m = inst.model
        nm = inst.name.replace(".", "_")
        nd = "(" + " ".join(inst.nodes) + ")"
        p = inst.params
        if m is dv.RESISTOR:
            body.append(f"{nm} {nd} resistor r={_fmt(p.get('r', 1e3))}")
        elif m is dv.CAPACITOR:
            body.append(f"{nm} {nd} capacitor c={_fmt(p.get('c', 1e-12))}")
        elif m is dv.INDUCTOR:
            body.append(f"{nm} {nd} inductor l={_fmt(p.get('l', 1e-9))}")
        elif m in (dv.VSOURCE, dv.ISOURCE):
            master = "vsource" if m is dv.VSOURCE else "isource"
            parts = [f"{nm} {nd} {master}",
                     _spectre_wave_params(inst.wave)]
            if p.get("acmag"):
                parts.append(f"mag={_fmt(p['acmag'])}")
                if p.get("acphase"):
                    parts.append(f"phase={_fmt(p['acphase'])}")
            body.append(" ".join(parts))
        elif m is dv.VCVS:
            body.append(f"{nm} {nd} vcvs gain={_fmt(p.get('gain', 1.0))}")
        elif m is dv.VCCS:
            body.append(f"{nm} {nd} vccs gm={_fmt(p.get('gm', 1.0))}")
        elif m in (dv.CCCS, dv.CCVS):
            # Spectre senses currents through a probe vsource
            gain = p.get("gain", p.get("r", 1.0))
            master = "cccs" if m is dv.CCCS else "ccvs"
            key = "gain" if m is dv.CCCS else "rm"
            body.append(f"{nm} {nd} {master} {key}={_fmt(gain)} "
                        f"probe={inst.sense[0]}")
        elif m is dv.MUTUAL:
            body.append(f"{nm} mutual_inductor ind1={inst.sense[0]} "
                        f"ind2={inst.sense[1]} coupling={_fmt(p.get('m', 0.0))}")
        elif m in (dv.DIODE, dv.DIODE_RS):
            mdl = _model_for(model_cards, m, "d", p, skip={"area"})
            area = p.get("area", 1.0)
            body.append(f"{nm} {nd} {mdl}"
                        + (f" area={_fmt(area)}" if area != 1.0 else ""))
        elif m is dv.BJT:
            mtype = "pnp" if p.get("type", 1.0) < 0 else "npn"
            mdl = _model_for(model_cards, m, mtype, p,
                             skip={"type", "area"})
            body.append(f"{nm} {nd} {mdl}")
        elif m is dv.MOSFET1:
            mtype = "pmos" if p.get("type", 1.0) < 0 else "nmos"
            mdl = _model_for(model_cards, m, mtype, p,
                             skip={"type", "w", "l"})
            body.append(f"{nm} {nd} {mdl} "
                        f"w={_fmt(p.get('w', m.defaults['w']))} "
                        f"l={_fmt(p.get('l', m.defaults['l']))}")
        else:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in p.items()
                          if not str(k).endswith("__given"))
            body.append(f"{nm} {nd} {m.name} {kv}".strip())
    for (mdl_name, mtype, items) in model_cards.values():
        # model masters keep the SPICE-compatible type names (d, npn,
        # nmos, ...) — the shape VACASK-style decks and our own Spectre
        # reader share (reference `cg_spectre.jl` does the same mapping)
        rev = {"vth": "vto", "cgs": "cgso", "cgd": "cgdo", "cgb": "cgbo"}
        kv = " ".join(f"{rev.get(k, k)}={_fmt(v)}" for k, v in items)
        lines.append(f"model {mdl_name} {mtype} {kv}".rstrip())
    lines.extend(body)
    return "\n".join(lines) + "\n"


#: dialect-trait table (the reference's `simulator_traits.jl`): writer,
#: comment leader, and whether the dialect wants a title line
DIALECTS = {
    "spice": {"writer": to_spice, "comment": "*", "title_line": True},
    "ngspice": {"writer": to_spice, "comment": "*", "title_line": True},
    "spectre": {"writer": to_spectre, "comment": "//",
                "title_line": False},
}


def convert(text: str, *, to: str = "spice") -> str:
    """Dialect conversion: parse (auto-detect SPICE/Spectre), re-emit
    (the reference's `spak-convert`, `SpiceArmyKnife.jl/README.md:8-24`)."""
    from .elaborate import elaborate_netlist

    cir, _ = elaborate_netlist(text)
    d = DIALECTS.get(to)
    if d is None:
        raise ValueError(f"unsupported target dialect {to!r}; "
                         f"supported: {sorted(DIALECTS)}")
    return d["writer"](cir)


# ---------------------------------------------------------------------------
# Circuit -> Verilog-A subcircuit export (the reference SpiceArmyKnife's
# `cg_veriloga.jl` backend, SURVEY §2.8): built-in R/C/L/V/I/E/G devices
# become contribution statements of one analog block; the result compiles
# back through our own VA compiler (round-trip tested).

def to_veriloga(cir: Circuit, module_name: str = None,
                ports=None) -> str:
    """Serialize a Circuit of built-in linear/source devices to a
    Verilog-A module. `ports`: external net names (default: all nets)."""
    name = module_name or (cir.title or "converted").split()[0]
    nets = []
    for inst in cir.instances:
        for nd in inst.nodes:
            if nd not in nets and nd not in ("0", "gnd"):
                nets.append(nd)
    ports = list(ports) if ports is not None else nets
    internal = [n for n in nets if n not in ports]

    def net(nd):
        return None if nd in ("0", "gnd") else nd

    def acc(p, n):
        p, n = net(p), net(n)
        if n is None:
            return f"V({p})"
        if p is None:
            return f"-V({n})"
        return f"V({p},{n})"

    lines = ['`include "disciplines.vams"',
             f"module {name}({', '.join(ports)});"]
    if ports:
        lines.append(f"  inout {', '.join(ports)};")
    decl = ports + internal
    if decl:
        lines.append(f"  electrical {', '.join(decl)};")
    body = []
    for inst in cir.instances:
        m = inst.model.name
        p = dict(inst.model.defaults, **inst.params)
        nd = inst.nodes

        def contrib(pn, nn, expr):
            pn, nn = net(pn), net(nn)
            tgt = (f"I({pn},{nn})" if pn and nn
                   else f"I({pn})" if pn else f"I({nn})")
            sgn = "" if pn else "-"
            body.append(f"  {tgt} <+ {sgn}{expr};")

        if m == "resistor":
            contrib(nd[0], nd[1], f"{acc(nd[0], nd[1])}/{_fmt(p['r'])}")
        elif m == "capacitor":
            contrib(nd[0], nd[1], f"ddt({_fmt(p['c'])}*{acc(nd[0], nd[1])})")
        elif m == "inductor":
            contrib(nd[0], nd[1],
                    f"idt({acc(nd[0], nd[1])})/{_fmt(p['l'])}")
        elif m == "vsource":
            w = inst.wave
            expr = _fmt(w.dc if w is not None else 0.0)
            if w is not None and w.kind == wf.WAVE_SIN:
                vo, va, fr = w.coeffs[0], w.coeffs[1], w.coeffs[2]
                expr = (f"{_fmt(vo)}+{_fmt(va)}"
                        f"*sin(6.283185307179586*{_fmt(fr)}*$abstime)")
            pn, nn = net(nd[0]), net(nd[1])
            tgt = (f"V({pn},{nn})" if pn and nn
                   else f"V({pn})" if pn else f"V({nn})")
            body.append(f"  {tgt} <+ {'' if pn else '-'}{expr};")
        elif m == "isource":
            w = inst.wave
            contrib(nd[0], nd[1], _fmt(w.dc if w is not None else 0.0))
        elif m == "vccs":
            contrib(nd[0], nd[1],
                    f"{_fmt(p['gm'])}*{acc(nd[2], nd[3])}")
        elif m == "vcvs":
            pn, nn = net(nd[0]), net(nd[1])
            tgt = (f"V({pn},{nn})" if pn and nn
                   else f"V({pn})" if pn else f"V({nn})")
            body.append(
                f"  {tgt} <+ {'' if pn else '-'}{_fmt(p['gain'])}"
                f"*{acc(nd[2], nd[3])};")
        else:
            raise ValueError(
                f"to_veriloga: unsupported device {inst.name!r} "
                f"({m}); supported: R, C, L, V, I, E, G")
    lines.append("  analog begin")
    lines.extend(body)
    lines.append("  end")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"
