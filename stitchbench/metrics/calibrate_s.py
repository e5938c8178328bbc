"""calibrate_s: host seconds of Stitcher.calibrate in set-up (with its
first mesh solve and the re-solve's prewarm)."""


def read(ctx):
    return ctx["calibrate_s"] or None
