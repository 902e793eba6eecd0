"""Verilog-A preprocessor: `define / `include / `ifdef / macros.

Covers the scope of the reference's VA preprocessor
(NyanVerilogAParser `src/parse/preproc.jl`): object- and function-like
macros with arguments, recursive expansion, `ifdef/`ifndef/`else/`endif,
`include resolution, `undef; the `__VAMS_ENABLE__`-style predefines are
implicit (disciplines are built in, like the reference).
"""
from __future__ import annotations

import os
import re


class PreprocError(ValueError):
    pass


_DEFINE_RE = re.compile(r"`define\s+(\w+)(\(([^)]*)\))?[ \t]*(.*)")
_MACRO_USE_RE = re.compile(r"`(\w+)")

_BUILTIN_TICKS = {
    # `ifdef-controlled std macros commonly tested by models
    "__VAMS_ENABLE__": "1",
    "__VAMS_COMPACT_MODELING__": "1",
    # constants.vams physical constants (usable as `P_K etc. without the
    # include, mirroring the reference's implicit disciplines/constants)
    "P_Q": "1.602176634e-19", "P_K": "1.380649e-23",
    "P_H": "6.62607015e-34", "P_EPS0": "8.8541878128e-12",
    "P_U0": "1.25663706212e-6", "P_C": "299792458.0",
    "P_CELSIUS0": "273.15",
    "M_PI": "3.14159265358979323846", "M_TWO_PI": "6.28318530717958647652",
    "M_PI_2": "1.57079632679489661923", "M_PI_4": "0.78539816339744830962",
    "M_1_PI": "0.31830988618379067154", "M_2_PI": "0.63661977236758134308",
    "M_SQRT2": "1.41421356237309504880",
    "M_SQRT1_2": "0.70710678118654752440",
    "M_E": "2.71828182845904523536", "M_LN2": "0.69314718055994530942",
    "M_LN10": "2.30258509299404568402",
    "M_LOG2E": "1.44269504088896340736",
    "M_LOG10E": "0.43429448190325182765",
}


def _strip_comments(text: str) -> str:
    out = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise PreprocError("unterminated /* comment")
            # keep newlines for line numbering
            out.append("\n" * text.count("\n", i, j))
            i = j + 2
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


class Preprocessor:
    def __init__(self, include_dirs=()):
        self.include_dirs = list(include_dirs)
        self.defines: dict[str, tuple] = {
            k: ((), v) for k, v in _BUILTIN_TICKS.items()}

    def process(self, text: str, cur_dir: str = ".") -> str:
        lines = _strip_comments(text).split("\n")
        out = []
        # conditional stack: (taken_now, any_branch_taken)
        stack: list[list] = []

        def active():
            return all(s[0] for s in stack)

        i = 0
        while i < len(lines):
            line = lines[i]
            # join continuation lines for `define
            stripped = line.lstrip()
            if stripped.startswith("`define") and active():
                while line.rstrip().endswith("\\") and i + 1 < len(lines):
                    i += 1
                    line = line.rstrip()[:-1] + " " + lines[i]
                    out.append("")  # keep line count roughly aligned
                m = _DEFINE_RE.match(line.lstrip())
                if not m:
                    raise PreprocError(f"bad `define: {line}")
                name, args, body = m.group(1), m.group(3), m.group(4)
                argnames = tuple(a.strip() for a in args.split(",")) \
                    if args is not None else None
                self.defines[name] = (argnames, body.strip())
                out.append("")
            elif stripped.startswith("`undef") and active():
                name = stripped.split()[1]
                self.defines.pop(name, None)
                out.append("")
            elif stripped.startswith("`ifdef") or \
                    stripped.startswith("`ifndef"):
                name = stripped.split()[1]
                want = stripped.startswith("`ifdef")
                hit = (name in self.defines) == want
                stack.append([hit and active(), hit])
                out.append("")
            elif stripped.startswith("`elsif"):
                name = stripped.split()[1]
                if not stack:
                    raise PreprocError("`elsif without `ifdef")
                hit = name in self.defines and not stack[-1][1]
                stack[-1] = [hit and all(s[0] for s in stack[:-1]),
                             stack[-1][1] or hit]
                out.append("")
            elif stripped.startswith("`else"):
                if not stack:
                    raise PreprocError("`else without `ifdef")
                taken = not stack[-1][1]
                stack[-1] = [taken and all(s[0] for s in stack[:-1]),
                             True]
                out.append("")
            elif stripped.startswith("`endif"):
                if not stack:
                    raise PreprocError("`endif without `ifdef")
                stack.pop()
                out.append("")
            elif stripped.startswith("`include") and active():
                m = re.search(r'`include\s+"([^"]+)"', stripped)
                if not m:
                    raise PreprocError(f"bad `include: {line}")
                path = self._find(m.group(1), cur_dir)
                if path is None:
                    # disciplines/constants are built in (implicit, like
                    # the reference parser)
                    if m.group(1) in ("disciplines.vams", "discipline.h",
                                      "constants.vams", "constants.h",
                                      "disciplines.h"):
                        out.append("")
                        i += 1
                        continue
                    raise PreprocError(f"include not found: {m.group(1)}")
                with open(path) as fh:
                    sub = self.process(fh.read(), os.path.dirname(path))
                out.append(sub)
            elif not active():
                out.append("")
            else:
                out.append(self._expand(line))
            i += 1
        return "\n".join(out)

    def _find(self, name, cur_dir):
        for d in [cur_dir] + self.include_dirs:
            cand = os.path.join(d, name)
            if os.path.exists(cand):
                return cand
        return None

    def _expand(self, line: str, depth=0) -> str:
        if depth > 50:
            raise PreprocError("macro recursion limit")
        if "`" not in line:
            return line

        def repl(m):
            name = m.group(1)
            if name not in self.defines:
                return m.group(0)
            argnames, body = self.defines[name]
            if argnames is None:
                return body
            # function-like: parse balanced parens after the match
            rest = line[m.end():]
            if not rest.lstrip().startswith("("):
                return body
            return m.group(0)  # handled by the loop below

        # handle function-like macros manually (need balanced parens)
        result = []
        i = 0
        while i < len(line):
            m = _MACRO_USE_RE.match(line, i)
            if not m:
                result.append(line[i])
                i += 1
                continue
            name = m.group(1)
            if name not in self.defines:
                result.append(m.group(0))
                i = m.end()
                continue
            argnames, body = self.defines[name]
            i = m.end()
            if argnames is None:
                result.append(body)
                continue
            # collect (args)
            while i < len(line) and line[i].isspace():
                i += 1
            if i >= len(line) or line[i] != "(":
                result.append(body)
                continue
            depth_p = 0
            args = []
            cur = []
            i += 1
            while i < len(line):
                ch = line[i]
                if ch == "(":
                    depth_p += 1
                    cur.append(ch)
                elif ch == ")":
                    if depth_p == 0:
                        args.append("".join(cur).strip())
                        i += 1
                        break
                    depth_p -= 1
                    cur.append(ch)
                elif ch == "," and depth_p == 0:
                    args.append("".join(cur).strip())
                    cur = []
                else:
                    cur.append(ch)
                i += 1
            expansion = body
            for an, av in zip(argnames, args):
                expansion = re.sub(rf"\b{re.escape(an)}\b", av, expansion)
            result.append(expansion)
        expanded = "".join(result)
        if expanded != line:
            return self._expand(expanded, depth + 1)
        return expanded
