"""Host seconds of stage 3's per-final initialization (the port's
`dt.init_final` phase: accumulation, EPIC hypotheses, their energies) per
final pair."""


def read(rec):
    phases = (rec.get("counts") or {}).get("phases") or {}
    if rec["unit"] != "finals" or "dt.init_final" not in phases:
        return None
    return phases["dt.init_final"][0] / rec["units"]
