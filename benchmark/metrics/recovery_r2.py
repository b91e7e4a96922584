"""Mean over the window's fits of the aligned R^2 of the posterior mean
against the true latents."""


def read(run):
    r2 = run.values.get("r2")
    return sum(r2) / len(r2) if r2 else None
