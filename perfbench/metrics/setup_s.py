"""Process start to the opening of the window: weights, engine, the
documents' prefill, the loop's warm-up and every graph capture."""


def read(run):
    return run.setup_s
