"""Seconds of the measured window per family completed in it (host
clock): the pipeline user's cost per family."""


def read(run):
    done = len(run.families())
    return run.window_s / done if done else None
