"""dc_wait_ms.job: host milliseconds per DC Newton iteration spent
waiting for the device: the port's spans `.sync` (the loop's any-lane
read) under the tiers of `prepare.op`, summed over the jobs, over the
iterations (`.iter#n`). Nothing where the port opens no such span."""

TIERS = ("direct", "gmin", "source", "ptran", "lm")


def tier_sum(t, suffix):
    return sum(v for k, v in t.items() if k.startswith("prepare.op.")
               and k.split(".")[2] in TIERS and k.endswith(suffix))


def read(run):
    n = sum(tier_sum(j["timings"], ".iter#n") for j in run.jobs)
    if not n:
        return None
    return 1e3 * sum(tier_sum(j["timings"], ".sync")
                     for j in run.jobs) / n
