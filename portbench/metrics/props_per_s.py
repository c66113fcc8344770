"""Satellite-epochs of every sweep sent in the window, over the window:
from the first send to the completion of the last sweep. Host clock."""


def read(run):
    if run.cell.traffic["kind"] != "propagate" or not run.window.requests:
        return None
    return len(run.window.requests) * run.props / run.window.seconds
