"""Patches of every chunk whose results reached the host in the window
over the window's seconds."""


def read(run):
    if run.kind != "serve":
        return None
    return run.count * run.batch / run.window_s
