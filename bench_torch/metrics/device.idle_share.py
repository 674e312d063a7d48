"""device.idle_share: 1 - (union of the device's kernel, copy and set
events) / the traced window's host-clock length."""


def read(tr):
    if tr.window_s <= 0 or not tr.device:
        return None
    return 1.0 - tr.busy_s / tr.window_s
