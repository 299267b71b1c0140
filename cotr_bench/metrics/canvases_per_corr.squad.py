"""Canvases the squad engine encoded (``GroupedStepper.canvas_count``, the
program's own counter, padding included) a correspondence returned, over
the window."""


def read(m):
    canvases = m.counters.get("canvases")
    if canvases is None:
        raise LookupError("canvases_per_corr.squad: the engine has no "
                          "_stepper.canvas_count")
    if not m.answers:
        raise LookupError("canvases_per_corr.squad: the window returned no "
                          "correspondence")
    return canvases / m.answers
