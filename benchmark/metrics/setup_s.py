"""setup_s: host seconds from the start of the run to the end of the
warm-up: imports, the card's context, the kernels' libraries, the
circuit and one warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
