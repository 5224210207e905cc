"""idle_share.train: the share of the training window in which the
device ran nothing: 1 - (the union of its spans) / the window."""


def read(window):
    if not window.events:
        return None
    return 100.0 * (1.0 - window.busy_seconds() / window.seconds)
