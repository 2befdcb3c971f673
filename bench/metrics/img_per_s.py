"""Images completed in the window over the window's seconds (a batch job's
rate); the window ends when the first step to finish past ``--seconds``
returns."""


def read(run):
    if run.kind != "closed" or run.window_s <= 0:
        return None
    return run.images_in_window / run.window_s
