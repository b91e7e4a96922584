"""Seconds from the process's start to the window's: imports, the kernel
build (first run in a checkout only), the data, the warm-up."""


def read(run):
    return run.setup_s
