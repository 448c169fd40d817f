"""The ``pack`` span per dispatch, in milliseconds.  Host enqueue time:
``pack`` reads nothing back, so its device work lands in ``dispatch``."""


def read(ctx):
    span, dispatch = ctx.spans.get("pack"), ctx.spans.get("dispatch")
    if not span or not dispatch:
        return None
    return 1e3 * span[0] / dispatch[1]
