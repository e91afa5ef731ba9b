"""Scene build: the host clock around the scene's compile and the culling
build in the set-up."""


def read(run):
    return run.build_s
