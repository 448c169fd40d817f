"""What a solve copies to its device and reads back, by planner stage, for
the port's tests on either device (torch only: the card's tests import
it too).

A graph's lift is its ``rowptr`` and ``colidx`` going through
``torch.from_numpy`` (``graphs.csr.lift_csr``); a readback is a call of a
tensor's ``tolist``, ``item``, ``cpu``, ``numpy`` or its ``bool()``,
``int()`` or ``float()``.  ``plan`` is ``Planner.assign``, ``pack`` the
planner's ``pack_problems``.
"""

import torch

READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__", "__float__")


def plan_pack_traffic(monkeypatch, session, queries, graph):
    """Solve ``queries`` on ``session``; returns the results, the stage of
    each copy of ``graph``'s host arrays, and the readbacks made in each
    stage."""
    import repro_torch.api.planner as tp

    stage = [None]
    lifts = []
    reads = {"plan": 0, "pack": 0}
    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        if a is graph.rowptr or a is graph.colidx:
            lifts.append(stage[0])
        return real_from_numpy(a)

    def counted(real):
        def method(t, *a, **k):
            if stage[0] in reads:
                reads[stage[0]] += 1
            return real(t, *a, **k)
        return method

    def staged(name, fn):
        def run(*a, **k):
            stage[0] = name
            try:
                return fn(*a, **k)
            finally:
                stage[0] = None
        return run

    with monkeypatch.context() as m:
        m.setattr(torch, "from_numpy", from_numpy)
        for name in READS:
            m.setattr(torch.Tensor, name, counted(getattr(torch.Tensor, name)))
        m.setattr(tp.Planner, "assign", staged("plan", tp.Planner.assign))
        m.setattr(tp, "pack_problems", staged("pack", tp.pack_problems))
        results = session.solve(queries)
    return results, lifts, reads
