"""Process start to the first timed request: keys, operands, the program's build
or load, capture and warm-up."""


def read(run):
    return run.setup_s
