"""Process start to the first timed request: imports, the kernel library
(built on a checkout's first run, loaded after), tables, frames made from
the seed, warm-up."""


def read(run):
    return run.setup_s
