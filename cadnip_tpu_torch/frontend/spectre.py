"""Spectre netlist dialect -> the same card AST as the SPICE parser.

Covers the Spectre grammar scope of the reference
(NyanSpectreNetlistParser Spectre mode, `src/parse/parse.jl`, +
`src/spc/codegen.jl:1877-2188` Spectre primitives): `//`/`*` comments,
line continuation `\\` and leading `+`, `simulator lang=...`, `global`,
`parameters`, `model`, `subckt`/`inline subckt`/`ends`,
`include [section=]`/`ahdl_include`, `library`/`section`/`endsection`/
`endlibrary` blocks, braced `if/else if/else` conditionals
(parse_conditional_block), user-defined functions
(`real f(a, b) { return expr; }`, parse_function_decl), bracketed
vectors `[...]` (parse_array), double-quoted string parameters,
instance lines `name (nodes) master p=v ...`, analysis statements
(`name tran ...`, `name dc`, `name ac ...`, `name noise ...`,
`name sweep ... { child }`, `name montecarlo ... { child }`), the
audit/no-op statements (`info`, `check`, `checklimit`, `set`, `shell`,
`statistics`, `paramset`), and the Spectre primitive masters resistor/
capacitor/inductor/vsource/isource/vcvs/vccs/cccs/ccvs/mutual_inductor.

Spectre number literals are case-sensitive (M = mega, m = milli) —
`parse_spectre_number` handles them; expressions use the shared Pratt
parser.
"""
from __future__ import annotations

import re

from .expressions import parse_expr
from .netlist import (DotCard, Element, IfBlock, LibSection, Netlist,
                      NetlistError, SubcktDef, split_fields)

_SPECTRE_MAG = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "k": 1e3,
                "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15,
                "a": 1e-18, "%": 1e-2}

_NUM_RE = re.compile(
    r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)([TGMKkmunpfa%]?)"
    r"(?:_?[A-Za-z]*)?$")   # optional unit tag: 1.8_V, 10k_Ohm, 60ps, 30ns


def parse_spectre_number(tok: str):
    m = _NUM_RE.match(tok)
    if not m:
        return None
    v = float(m.group(1))
    if m.group(2):
        v *= _SPECTRE_MAG[m.group(2)]
    return v


# Spectre primitive master -> (SPICE letter, param translation)
_PRIMITIVES = {
    "resistor": "R", "capacitor": "C", "inductor": "L",
    "vsource": "V", "isource": "I",
    "vcvs": "E", "vccs": "G", "cccs": "F", "ccvs": "H",
    "iprobe": "V",   # 0V source used as current probe
}

_ANALYSES = {"tran", "dc", "ac", "noise", "op", "sp", "pss", "xf",
             "sweep", "montecarlo"}
_NOOP_STMTS = {"check", "checklimit", "set", "shell", "paramtest"}


def _mask_call_values(s: str, calls: list) -> str:
    """Replace `key=expr(...)`-style values (a value containing parens,
    ending at depth-0 whitespace or ')') with placeholders — a Spectre
    parameter value is a full expression, and the generic tokenizer
    would otherwise split the call arguments into a separate group."""
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        out.append(ch)
        if ch == "=":
            i += 1
            while i < len(s) and s[i] == " ":
                i += 1
            j, depth = i, 0
            while j < len(s):
                c = s[j]
                if c == "(":
                    depth += 1
                elif c == ")":
                    if depth == 0:
                        break
                    depth -= 1
                elif c.isspace() and depth == 0:
                    break
                j += 1
            val = s[i:j]
            if "(" in val:
                calls.append(val)
                out.append(f" __spc{len(calls) - 1}__ ")
            else:
                out.append(val)
            i = j
            continue
        i += 1
    return "".join(out)


def sp_fields(s: str, ln: int):
    """Spectre-aware field tokenization: `split_fields` plus bracketed
    vectors `[a b (expr) ...]` -> ('vec', [field, ...]), double-quoted
    strings -> ('str', text), and function-call parameter values
    `k=f(a, b)` -> ('expr', text) (reference parse_array / take_string /
    parse_function_call, `src/parse/parse.jl:471,567,730`)."""
    subs = []

    def stash(m):
        subs.append(m.group(0))
        return f" __sp{len(subs) - 1}__ "

    masked = re.sub(r'"[^"]*"|\[[^\]]*\]', stash, s)
    calls = []
    masked = _mask_call_values(masked, calls)
    fields = split_fields(masked, ln)

    def restore(f):
        if f[0] == "word" and re.fullmatch(r"__sp(\d+)__", f[1]):
            raw = subs[int(f[1][4:-2])]
            if raw.startswith('"'):
                return ("str", raw[1:-1])
            return ("vec", split_fields(raw[1:-1], ln))
        if f[0] == "word" and re.fullmatch(r"__spc(\d+)__", f[1]):
            return ("expr", calls[int(f[1][5:-2])])
        if f[0] == "kw":
            return ("kw", f[1], restore(f[2]))
        if f[0] == "group":
            return ("group", [restore(x) for x in f[1]])
        return f

    return [restore(f) for f in fields]


def _brace_depth(s: str) -> int:
    return s.count("{") - s.count("}")


def _until_close(lines, pos):
    """Collect logical lines from `pos` until the brace depth opened by
    the caller's line returns to zero. Returns (inner, next_pos,
    closer): `closer` is the text after the closing '}' when the closer
    line continues (`} else ...`), else None."""
    depth = 1
    inner = []
    while pos < len(lines):
        ln, s = lines[pos]
        st = s.lstrip()
        if depth == 1 and st.startswith("}"):
            # our closer — which may continue (`} else ... {`): hand the
            # trailing text back for the caller to re-dispatch
            rest = st[1:].strip()
            return inner, pos + (0 if rest else 1), (rest or None)
        depth += _brace_depth(s)
        inner.append((ln, s))
        pos += 1
    raise NetlistError("missing '}'", lines[-1][0] if lines else 0, "")


def _parse_sp_if(lines, pos):
    """Braced conditional: `if (cond) { ... } else if (...) { ... }
    else { ... }` -> the shared IfBlock card (same evaluation path as
    SPICE `.if`; reference parse_conditional_block)."""
    ln0, s0 = lines[pos]
    branches = []
    cur = s0.strip()
    while True:
        m = re.match(r"(?:else\s+)?if\s*\((?P<cond>.*)\)\s*\{$", cur)
        if m:
            cond = parse_expr(m.group("cond"))
        elif re.match(r"else\s*\{$", cur):
            cond = None
        else:
            raise NetlistError(f"cannot parse conditional {cur!r}",
                               ln0, s0)
        inner, pos, closer = _until_close(lines, pos + 1)
        body, _ = _parse_block(inner, 0, None)
        branches.append((cond, body))
        if closer is None or cond is None:
            return IfBlock("if", ln0, s0, branches=branches), pos
        cur = closer.strip()
        if not cur.startswith("else"):
            raise NetlistError(f"unexpected text after '}}': {cur!r}",
                               ln0, s0)
        if cur == "else":        # `} else` with `{` on the next line
            pos += 1
            nxt = lines[pos][1].strip() if pos < len(lines) else ""
            cur = "else " + nxt


def _parse_sp_func(lines, pos):
    """User-defined function: `real f(real a, real b) { return expr; }`
    (reference parse_function_decl, `src/parse/parse.jl:101`). Returns a
    DotCard('spectre_func') holding the name, argument names, and the
    body expression AST."""
    ln0, s0 = lines[pos]
    m = re.match(r"(?:real|integer)\s+(\w+)\s*\(([^)]*)\)\s*(\{?)\s*(.*)$",
                 s0.strip())
    if not m:
        raise NetlistError("cannot parse function declaration", ln0, s0)
    name, argstr, brace, rest = m.groups()
    args = [a.split()[-1] for a in argstr.split(",") if a.strip()]
    if brace:
        if "}" in rest:                    # one-liner
            body_text = rest[:rest.index("}")]
            pos += 1
        else:
            inner, pos, _closer = _until_close(lines, pos + 1)
            body_text = " ".join(s for _, s in inner) + " " + rest
    else:
        raise NetlistError("function declaration needs a '{' body",
                           ln0, s0)
    rm = re.search(r"return\s+(.*?);", body_text)
    if not rm:
        raise NetlistError("function body needs 'return expr;'", ln0, s0)
    expr = parse_expr(rm.group(1))
    return DotCard("spectre_func", ln0, s0,
                   kwargs={"name": name.lower(), "args": args,
                           "expr": expr}), pos


def _parse_library(lines, pos):
    """`library NAME / section S ... endsection ... endlibrary` ->
    LibSection cards, selected by `include "f" section=S` / `.lib`
    (reference Spectre library files)."""
    ln0, s0 = lines[pos]
    cards = []
    pos += 1
    cur_name, cur, cur_ln = None, [], ln0
    while pos < len(lines):
        ln, s = lines[pos]
        w = s.split()
        low = w[0].lower() if w else ""
        if low == "endlibrary":
            pos += 1
            break
        if low == "section":
            cur_name, cur, cur_ln = w[1], [], ln
        elif low == "endsection":
            body, _ = _parse_block(cur, 0, None)
            cards.append(LibSection("libsec", cur_ln, s,
                                    name=cur_name, body=body))
            cur_name, cur = None, []
        elif cur_name is not None:
            cur.append((ln, s))
        pos += 1
    return cards, pos


def _logical_lines(text: str):
    out = []
    for ln, raw in enumerate(text.splitlines(), 1):
        s = raw.rstrip()
        s = re.sub(r"//.*", "", s)
        if not s.strip() or s.lstrip().startswith("*"):
            continue
        if s.rstrip().endswith("\\"):
            s = s.rstrip()[:-1]
            if out and out[-1][2]:
                out[-1] = (out[-1][0], out[-1][1] + " " + s.strip(), True)
            else:
                out.append((ln, s.strip(), True))
            continue
        if out and out[-1][2]:
            out[-1] = (out[-1][0], out[-1][1] + " " + s.strip(), False)
        elif s.lstrip().startswith("+"):
            out[-1] = (out[-1][0], out[-1][1] + " " + s.lstrip()[1:], False)
        else:
            out.append((ln, s.strip(), False))
    return [(ln, s) for ln, s, _ in out]


def looks_like_spectre(text: str) -> bool:
    head = text[:2000]
    if re.search(r"simulator\s+lang\s*=\s*spectre", head):
        return True
    if re.search(r"^\s*\w+\s*\([^)]*\)\s*\w+", head, re.M):
        return True
    # statement-keyword openers (library files often start bare)
    for raw in head.splitlines():
        s = re.sub(r"//.*", "", raw).strip()
        if not s or s.startswith("*"):
            continue
        return s.split()[0].lower() in (
            "library", "section", "parameters", "global", "ahdl_include",
            "paramset", "statistics", "inline")
    return False


_LANG_RE = re.compile(r"^\s*simulator\s+lang\s*=\s*(\w+)", re.I)


def initial_lang(text: str) -> str:
    """Dialect of the text BEFORE the first `simulator lang=` directive
    (mixed-language decks, reference NyanSpectreNetlistParser
    `test/examples/mixed_langs.cir`): a leading SPICE element/dot card
    means the deck starts in SPICE mode."""
    for raw in text.splitlines():
        s = re.sub(r"//.*", "", raw).strip()
        if not s or s.startswith("*"):
            continue
        if _LANG_RE.match(s):
            return "spectre"
        if s.startswith("."):
            return "spice"
        if re.match(r"^\w+\s*\(", s):
            return "spectre"
        w0 = s.split()[0].lower()
        if w0 in ("simulator", "global", "parameters", "model", "subckt",
                  "include", "ahdl_include", "save", "ends", "real",
                  "paramset", "library", "section", "inline",
                  "statistics", "if"):
            return "spectre"
        # SPICE element line: letter + digits/name then bare nodes
        return "spice"
    return "spectre"


def parse_spectre(text: str, start_lang: str | None = None) -> Netlist:
    """Parse a Spectre (or mixed-language) deck. `simulator lang=spice`
    switches the line dialect to SPICE until the next `simulator
    lang=spectre` (reference NyanSpectreNetlistParser mixed mode)."""
    # split into language segments on `simulator lang=` directives
    lang = start_lang or initial_lang(text)
    segs = []           # (lang, first_line_no, [raw lines])
    cur, start = [], 1
    for i, raw in enumerate(text.splitlines(), 1):
        m = _LANG_RE.match(re.sub(r"//.*", "", raw))
        if m:
            segs.append((lang, start, cur))
            lang, cur, start = m.group(1).lower(), [], i + 1
        else:
            cur.append(raw)
    segs.append((lang, start, cur))
    cards = []
    for lg, start, ls in segs:
        if not any(x.strip() for x in ls):
            continue
        body = "\n" * (start - 1) + "\n".join(ls)   # preserve line numbers
        if lg == "spice":
            from .netlist import parse_netlist
            cards.extend(parse_netlist(body, title_line=False).cards)
        else:
            cards.extend(_parse_block(_logical_lines(body), 0, None)[0])
    return Netlist(title="", cards=cards)


def _parse_block(lines, pos, end_name):
    cards = []
    while pos < len(lines):
        ln, s = lines[pos]
        words = s.split()
        w0 = words[0]
        low = w0.lower()
        if low == "ends":
            if end_name is None:
                raise NetlistError("unexpected 'ends'", ln, s)
            return cards, pos + 1
        if low == "simulator":
            pos += 1
            continue
        if low == "if":
            card, pos = _parse_sp_if(lines, pos)
            cards.append(card)
            continue
        if low in ("real", "integer") and "(" in s:
            card, pos = _parse_sp_func(lines, pos)
            cards.append(card)
            continue
        if low == "library":
            libcards, pos = _parse_library(lines, pos)
            cards.extend(libcards)
            continue
        if low in ("statistics", "paramset"):
            # parsed and preserved for introspection; no circuit effect
            # here (statistics blocks feed montecarlo, handled there)
            if s.rstrip().endswith("{"):
                inner, pos, _c = _until_close(lines, pos + 1)
            else:
                inner, pos = [], pos + 1
            cards.append(DotCard("spectre_" + low, ln, s,
                                 kwargs={"body": [t for _, t in inner]}))
            continue
        if low == "inline" and len(words) >= 2 \
                and words[1].lower() == "subckt":
            # `inline subckt` differs from subckt only in result naming
            # (the primary instance keeps the caller's name); structure
            # and parameters elaborate identically here
            lines = list(lines)
            lines[pos] = (ln, s.split(None, 1)[1])
            continue
        if low == "global":
            cards.append(DotCard("global", ln, s,
                                 fields=[("word", w) for w in words[1:]
                                         if w != "0"]))
            pos += 1
            continue
        if low == "parameters":
            fields = sp_fields(s[len(w0):], ln)
            kwargs = {f[1]: f[2] for f in fields if f[0] == "kw"}
            cards.append(DotCard("param", ln, s, kwargs=kwargs))
            pos += 1
            continue
        if low == "model":
            # model name mtype p=v ... -> .model card shape
            fields = sp_fields(s[len(w0):], ln)
            cards.append(DotCard("model", ln, s,
                                 fields=[f for f in fields
                                         if f[0] != "kw"],
                                 kwargs={f[1]: f[2] for f in fields
                                         if f[0] == "kw"}))
            pos += 1
            continue
        if low in ("include",):
            path = words[1]
            sect = None
            m = re.search(r"section\s*=\s*(\w+)", s)
            if m:
                sect = m.group(1)
            fields = [("word", path.strip('"'))]
            if sect:
                fields.append(("word", sect))
            cards.append(DotCard("lib" if sect else "include", ln, s,
                                 fields=fields))
            pos += 1
            continue
        if low == "ahdl_include":
            cards.append(DotCard("ahdl_include", ln, s,
                                 fields=[("word", words[1].strip('"'))]))
            pos += 1
            continue
        if low == "subckt":
            name = words[1]
            # ports in parens or bare
            m = re.match(r"subckt\s+\w+\s*\(([^)]*)\)", s)
            if m:
                ports = m.group(1).split()
                rest = s[m.end():]
            else:
                ports = words[2:]
                rest = ""
            params = {}
            body_cards = []
            pos += 1
            # optional 'parameters' line inside handled by recursion
            inner, pos = _parse_block(lines, pos, name)
            for c in inner:
                if isinstance(c, DotCard) and c.kind == "param":
                    params.update(c.kwargs)
                else:
                    body_cards.append(c)
            cards.append(SubcktDef("subckt", ln, s, name=name, ports=ports,
                                   params=params, body=body_cards))
            continue
        if low in ("ic", "nodeset"):
            # `ic node=v ...` -> same card shape as SPICE .ic/.nodeset
            fields = split_fields(s[len(w0):], ln)
            cards.append(DotCard(low, ln, s,
                                 kwargs={f[1]: f[2] for f in fields
                                         if f[0] == "kw"}))
            pos += 1
            continue
        if low == "save":
            # `save A Y` signal-save directive -> .save card shape
            cards.append(DotCard("save", ln, s,
                                 fields=[("word", w) for w in words[1:]]))
            pos += 1
            continue
        # statement-position keywords: `name options|info|alter k=v ...`
        if len(words) >= 2 and words[1].lower() in ("options", "option"):
            fields = sp_fields(" ".join(words[2:]), ln)
            cards.append(DotCard("option", ln, s,
                                 fields=[f for f in fields
                                         if f[0] != "kw"],
                                 kwargs={f[1]: f[2] for f in fields
                                         if f[0] == "kw"}))
            pos += 1
            continue
        if len(words) >= 2 and words[1].lower() == "info":
            pos += 1          # audit/info statements: no circuit effect
            continue
        if len(words) >= 2 and words[1].lower() == "alter":
            fields = split_fields(" ".join(words[2:]), ln)
            cards.append(DotCard("spectre_alter", ln, s,
                                 kwargs={f[1]: f[2] for f in fields
                                         if f[0] == "kw"}))
            pos += 1
            continue
        if len(words) >= 2 and words[1].lower() == "altergroup":
            # `name altergroup { include/parameters ... }` — body cards
            # preserved for introspection (sequential re-elaboration is
            # not run; reference `src/spectre.jl` altergroup semantics)
            j = pos + 1
            inner = []
            while j < len(lines) and lines[j][1].strip() != "}":
                inner.append(lines[j])
                j += 1
            body_cards, _ = _parse_block(inner, 0, None)
            cards.append(DotCard("spectre_altergroup", ln, s,
                                 fields=[("word", w0)],
                                 kwargs={"body": body_cards}))
            pos = j + 1
            continue
        if len(words) >= 2 and words[1].lower() in _NOOP_STMTS:
            # audit statements (reference parse_check/checklimit/set/
            # shell/paramtest): no circuit effect
            if s.rstrip().endswith("{"):
                _inner, pos, _c = _until_close(lines, pos + 1)
            else:
                pos += 1
            continue
        # analysis statement: name analysistype p=v ... [ { children } ]
        if len(words) >= 2 and words[1].lower() in _ANALYSES:
            kind = words[1].lower()
            body = s[s.find(words[1]) + len(words[1]):]
            braced = body.rstrip().endswith("{")
            if braced:
                body = body.rstrip()[:-1]
            fields = sp_fields(body, ln)
            kwargs = {f[1]: f[2] for f in fields if f[0] == "kw"}
            if braced:
                inner, pos, _c = _until_close(lines, pos + 1)
                children, _ = _parse_block(inner, 0, None)
                kwargs["body"] = children
            else:
                pos += 1
            cards.append(DotCard("spectre_" + kind, ln, s,
                                 fields=[f for f in fields
                                         if f[0] != "kw"], kwargs=kwargs))
            continue
        # instance line: name (nodes) master p=v ... | name n1 n2 master ...
        m = re.match(r"(\S+)\s*\(([^)]*)\)\s*(\S+)(.*)", s)
        if m:
            name, nodes, master, rest = (m.group(1), m.group(2).split(),
                                         m.group(3), m.group(4))
        else:
            fields0 = sp_fields(s[len(w0):], ln)
            poss = [f[1] for f in fields0 if f[0] == "word"]
            if len(poss) < 2:
                raise NetlistError(f"cannot parse instance line", ln, s)
            name = w0
            nodes = poss[:-1]
            master = poss[-1]
            kwargs = {f[1]: f[2] for f in fields0 if f[0] == "kw"}
            cards.append(_SpectreInst("spectre_inst", ln, s, name=name,
                                      nodes=nodes, master=master,
                                      kwargs=kwargs))
            pos += 1
            continue
        fields = sp_fields(rest, ln)
        kwargs = {f[1]: f[2] for f in fields if f[0] == "kw"}
        cards.append(_SpectreInst("spectre_inst", ln, s, name=name,
                                  nodes=nodes, master=master,
                                  kwargs=kwargs))
        pos += 1
    if end_name is not None:
        raise NetlistError(f"missing 'ends {end_name}'")
    return cards, pos


import dataclasses  # noqa: E402


@dataclasses.dataclass
class _SpectreInst:
    kind: str
    line_no: int
    line: str
    name: str = ""
    nodes: list = dataclasses.field(default_factory=list)
    master: str = ""
    kwargs: dict = dataclasses.field(default_factory=dict)
