"""Seconds from the process's start to the window's opening: building the
program, loading or making its weights and inputs, every warm-up step and,
in a first run, the kernels' build."""


def read(run):
    return run.setup_s or None
