"""Set-up: process start to the first timed call (imports, CUDA
initialisation, the seeded plan, ingest and stacking, the key's warm-up
and capture, a call on each distinct batch), host seconds."""


def read(run):
    return run.setup_s
