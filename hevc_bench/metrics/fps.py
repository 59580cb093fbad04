"""fps: frames whose AUs the window returned, over the window's wall
seconds (which end in a device synchronise): all the work over all the
time. The traced slice of a `--trace 1` run follows the window and is not
counted."""


def read(run):
    return run.frames_in(run.untraced_calls()) / run.window_s
