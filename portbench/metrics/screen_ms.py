"""The window over the screens completed in it: from the first screen's
call to the last one's numpy pair list. Host clock."""


def read(run):
    if run.cell.traffic["kind"] != "screen_all" or not run.window.requests:
        return None
    return run.window.seconds / len(run.window.requests) * 1e3
