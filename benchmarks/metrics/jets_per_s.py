"""Jets solved per second: every jet of the window's calls over the
window's seconds."""


def read(rec):
    if rec["unit"] != "jets":
        return None
    win = rec["window"]
    return sum(win.units) / win.seconds
