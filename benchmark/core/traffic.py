"""The benchmark's inputs, made from the seed: the one general generator
that every traffic mix feeds.

A configuration (`configs/<name>.json`) names a netlist template, in which
`${inst.param}` marks each drawn value, and `draws`: for each such name a
nominal value and a relative Gaussian spread. A job's inputs are the
template with one draw written in (one seeded netlist per job), or, for a
sweep, the template at its nominal values and a table of `lanes` draws per
name. Draw k of a run comes from `numpy.random.default_rng([seed, k])`, so
the same seed gives the same inputs, and every seed the same sizes, spans
and steps with other component values. A mix with a `pool` ({"size": P,
"seed": S}) gives every seed the same P draws, those of seed S, and the
run's seed only their order: job k takes member k mod P of the seed's
permutation, so every run does the same work.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CHECK_STREAM = 2 ** 41   # the draw index of the check's sample
POOL_STREAM = 2 ** 42    # the draw index of a pool's order
_MARK = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json (kind: configs, traffic, workloads)."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def template(cfg: dict) -> str:
    return (ROOT / "configs" / cfg["template"]).read_text()


def rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, int(k)])


def draw(cfg: dict, gen: np.random.Generator, size=None) -> dict:
    """One Gaussian draw per name of `cfg["draws"]`, in file order."""
    out = {}
    for name, d in cfg["draws"].items():
        nom = float(d["nominal"])
        out[name] = gen.normal(nom, float(d["sigma_rel"]) * abs(nom), size)
    return out


def render(cfg: dict, values: dict | None = None) -> str:
    """The netlist text with `values` (default: the nominal ones) written
    in, each as the shortest decimal that reads back to the same float."""
    vals = {k: float(d["nominal"]) for k, d in cfg["draws"].items()}
    vals.update({k: float(v) for k, v in (values or {}).items()})

    def sub(m):
        return repr(vals[m.group(1)])
    return _MARK.sub(sub, template(cfg))


def job_netlist(cfg: dict, seed: int, k: int, pool: dict | None = None) -> str:
    """Job k's netlist: the template with draw k of the seed written in,
    or, with a `pool`, the pool's member that the seed puts at k."""
    if pool:
        size = int(pool["size"])
        order = rng(seed, POOL_STREAM).permutation(size)
        seed, k = pool["seed"], int(order[k % size])
    return render(cfg, draw(cfg, rng(seed, k)))


def sweep_table(cfg: dict, seed: int, k: int, lanes: int) -> dict:
    """Sweep k's Monte Carlo table {name: values [lanes]}."""
    return draw(cfg, rng(seed, k), lanes)
