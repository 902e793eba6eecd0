"""k2_group_eval_cycles.job: K2's clock64 cycles in the device function of
the circuit's largest device group (the one with the most local unknowns:
the 26 MOSFETs of both DFF decks) per Newton iteration: the port's program
counter `integrate.group_cycles#n` (`sol.group_cycles`), summed over the
jobs, over their Newton iterations (`sol.stats.nnewton`). On one topology
it sets the device function that the Verilog-A compiler emits (ekv26)
against the hand-written level-1 MOSFET. Nothing where the port counts no
such cycles."""

KEY = "integrate.group_cycles#n"


def read(run):
    if any(KEY not in j["timings"] for j in run.jobs):
        return None
    return (sum(j["timings"][KEY] for j in run.jobs)
            / sum(j["nnewton"] for j in run.jobs))
