"""setup_s: seconds from the process's start to the first timed count:
torch import, CUDA init, corpus and panel made on the card from the seed,
the program's tables, kernel load (and build, on a checkout's first run),
warm-up."""


def read(run):
    return run["setup_s"]
