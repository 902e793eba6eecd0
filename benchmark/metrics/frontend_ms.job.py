"""frontend_ms.job: mean host milliseconds of `parse_spice` per job (the
benchmark's own span around the call)."""


def read(run):
    return 1e3 * sum(j["parse_s"] for j in run.jobs) / len(run.jobs)
