"""setup_s: seconds from process start to the first timed frame: imports,
CUDA start-up, kernel builds (a checkout's first run), the clip's
synthesis, the set-up IDR or seeded reference, and the warm-up."""


def read(run):
    return run.setup_s
