"""job_wall_s: the host wall of all finished jobs (netlist text to waveform
on the device) over their count."""


def read(run):
    return run.window_s / len(run.jobs)
