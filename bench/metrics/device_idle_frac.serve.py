"""The device's idle share of the traced retrieval window: 1 - busy /
window, where busy is the union of every kernel, copy and fill."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr.busy_s <= 0 or tr.window_s <= 0 else 100.0 * (1.0 - tr.busy_s / tr.window_s)
