"""Undirected edges of every decompose completed in the window, over the
window's seconds: GraphChallenge's K-truss rate."""


def read(window):
    return window.work / window.seconds if window.work else None
