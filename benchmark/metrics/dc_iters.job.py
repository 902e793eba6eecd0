"""dc_iters.job: mean Newton iterations of the DC operating point per job:
the counts `prepare.op.<tier>...iter#n` of the port's spans, summed over
the tiers a job took (direct, gmin, source, ptran, lm). Nothing where
the port opens no such span."""

TIERS = ("direct", "gmin", "source", "ptran", "lm")


def iters(t):
    return sum(v for k, v in t.items() if k.startswith("prepare.op.")
               and k.split(".")[2] in TIERS and k.endswith(".iter#n"))


def read(run):
    if any("prepare.op" not in j["timings"] for j in run.jobs):
        return None
    return sum(iters(j["timings"]) for j in run.jobs) / len(run.jobs)
