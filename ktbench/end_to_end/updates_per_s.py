"""Update batches committed in the window, over the window's seconds."""


def read(window):
    return window.work / window.seconds if window.work else None
