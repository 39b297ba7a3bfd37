"""device_idle_pct (%, device layer, device trace): the share of the
traced window in which no kernel, copy or set ran on the device."""


def read(w):
    if w.device is None or not w.device.ops:
        return None
    return (1.0 - w.device.busy_s / w.device.window_s) * 100.0
