"""Window seconds over the leave-one-neuron-out passes completed in it (the
pass running at the close completes and counts, with its time)."""


def read(run):
    if run.traffic["kind"] != "lono" or not run.items:
        return None
    return run.window_s / len(run.items)
