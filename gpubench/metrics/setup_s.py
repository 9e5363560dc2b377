"""setup_s: process start to the window's start: imports, generation,
registration, the kernel's load (its build in a checkout's first run),
one run of each query of the mix. Host clock."""


def read(rec):
    return rec.setup_s
