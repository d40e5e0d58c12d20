"""Process start to the first due request (serving) or the first timed
step (training)."""


def read(run):
    return run['setup_s']
