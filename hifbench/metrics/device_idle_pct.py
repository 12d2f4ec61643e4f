"""Device: 100 x (1 - the union of the device's kernel and copy intervals
over the traced window's wall time)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
