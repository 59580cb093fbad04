"""launches_per_frame (layer device): kernels that ran on the card in the
traced slice over the frames whose AUs the slice returned."""


def read(run):
    if run.trace is None:
        return None
    frames = run.frames_in(run.traced_calls())
    return run.trace["launches"] / frames if frames else None
