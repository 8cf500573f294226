"""Patches of every train step completed in the window over the
window's seconds (the window ends in a synchronise)."""


def read(run):
    if run.kind != "train":
        return None
    return run.count * run.batch / run.window_s
