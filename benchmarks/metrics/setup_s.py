"""Set-up seconds: from the start of the run to the end of the warm-up call
(imports, the inputs made from the seed, the kernels built or loaded, the
graphs captured)."""


def read(rec):
    return rec["setup_s"]
