"""dc_iter_ms.job: host milliseconds per Newton iteration of the DC
operating point: the port's spans `.iter` (the host's dispatch of one
iteration) and `.sync` (its wait for the device at the loop's any-lane
read) under the tiers of `prepare.op`, summed over the jobs, over the
iterations (`.iter#n`). Nothing where the port opens no such span."""

TIERS = ("direct", "gmin", "source", "ptran", "lm")


def tier_sum(t, suffixes):
    return sum(v for k, v in t.items() if k.startswith("prepare.op.")
               and k.split(".")[2] in TIERS and k.endswith(suffixes))


def read(run):
    n = sum(tier_sum(j["timings"], (".iter#n",)) for j in run.jobs)
    if not n:
        return None
    s = sum(tier_sum(j["timings"], (".iter", ".sync")) for j in run.jobs)
    return 1e3 * s / n
