"""fps: output frames complete on the card inside the window (the sink's
completion stamps after the consumer's wait on each frame), per second
of the window."""


def read(ctx):
    return ctx["completed_in_window"] / ctx["seconds"]
