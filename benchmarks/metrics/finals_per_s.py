"""Final pairs tracked per second: every final pair of the window's calls
over the window's seconds."""


def read(rec):
    if rec["unit"] != "finals":
        return None
    win = rec["window"]
    return sum(win.units) / win.seconds
