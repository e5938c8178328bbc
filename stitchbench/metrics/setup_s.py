"""setup_s: seconds from the process's start to the window's first frame
set: the scene, the build, the calibration, the programs' captures and
the warm-up frames."""


def read(ctx):
    return ctx["setup_s"]
