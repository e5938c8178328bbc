"""step_device_ms.dev: card milliseconds of all kernels and copies in the
traced window (summed over streams) per output frame completed in it."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames"]:
        return None
    return tr["device_s"] / tr["frames"] * 1e3
