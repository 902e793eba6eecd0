"""device_idle.job, device_idle.sweep: 100 (1 - busy / wall) over the
traced part of the cell's work: busy is the union of the device's activity
intervals in the trace, wall the host's clock around the part (each entry,
`entries/<entry>.py`, says which part it traces)."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
