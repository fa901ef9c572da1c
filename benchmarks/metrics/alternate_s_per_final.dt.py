"""Host seconds inside the port's `dt.alternate` spans (propagation, NMS,
unary and pairwise terms, the TRW-S solve) per final pair."""


def read(rec):
    if rec.get("events") is None or rec["unit"] != "finals":
        return None
    total = sum(b - a for name, on_dev, a, b in rec["events"]
                if not on_dev and name == "dt.alternate")
    return total / 1e9 / rec["units"] if total else None
