"""Window seconds over the fits completed in it (the fit running at the
close completes and counts, with its time)."""


def read(run):
    if run.traffic["kind"] != "fit" or not run.items:
        return None
    return run.window_s / len(run.items)
