"""Set-up: from the process's start to the first timed request (imports,
CUDA context, kernel library, the catalog built from TLE text, every
request shape of the mix sent once). Host clock."""


def read(run):
    return run.setup_s
