"""ParameterList-compatible configuration system.

Parses the reference's tab-separated `.cfg` files (utils/parameter_list.cpp):
  - lines are `key<TAB>value`, `#` starts a comment line
  - ~20 special keys bound to attributes (file, output, start, Jets,
    jet_estimation, center/extent, file_gt, occlusions, ...)
  - any other key goes into a generic map with typed getters and defaults
  - multi-valued parameters `(a,b,c)` expand into a Cartesian experiment grid
    iterated with next_exp()  (parameter_list.cpp:499-523, 362-382)
  - cfgString() round-trips configs to disk (parameter_list.cpp:390-497)
"""
from __future__ import annotations

import math
import re
from enum import IntEnum


class Verbosity(IntEnum):
    """Verbosity bit-string positions (utils/parameter_list.h:18)."""

    VER_CMD = 0
    VER_IN_GT = 1
    VER_IMG_PYR = 2
    VER_FLO_PYR = 3
    WRITE_FILES = 4


MAX_VERBOSITY_STATES = 10


def _parse_value_list(value: str) -> list[str]:
    """`(a,b,c)` -> [a, b, c]; otherwise a single-element list."""
    value = value.strip()
    if value.startswith("("):
        inner = value.strip("()")
        return [v for v in (s.strip() for s in inner.split(",")) if v]
    return [value]


def _to_bool(s: str) -> bool:
    return s.strip() != "0"


def _atof(s: str) -> float:
    """C-style atof: parse the leading numeric prefix, 0.0 on failure."""
    m = re.match(r"\s*[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?)", s)
    return float(m.group(0)) if m else 0.0


def _atoi(s: str) -> int:
    m = re.match(r"\s*[-+]?\d+", s)
    return int(m.group(0)) if m else 0


class ParameterList:
    SPECIAL_KEYS = (
        "id", "name", "category", "file", "file_gt", "occlusions", "output",
        "start", "jet_estimation", "jet_weight", "jet_fps", "jet_S", "F",
        "Jets", "pixel", "center", "extent", "bf_weight",
    )

    def __init__(self, filename: str | None = None, clone: "ParameterList | None" = None):
        self.verbose: str = "0" * MAX_VERBOSITY_STATES
        self.file: str = ""
        self.file_list: list[str] = []
        self.id_list: list[int] = []
        self.name_list: list[str] = []
        self.category_list: list[str] = []
        self.sequence_start: int = 0
        self.sequence_start_list: list[int] = []
        self.jet_estimation: list[str] = []
        self.jet_weight: list[float] = []
        self.jet_fps: list[int] = []
        self.jet_S: list[int] = []
        self.output: str = ""
        self.F: int = 0
        self.Jets: int = 0
        self.file_gt: str = ""
        self.file_gt_list: list[str] = []
        self.occlusions_list: list[str] = []
        self.pixel: list[list[tuple[float, float]]] = []
        self.set: list[int] = []
        self.center: tuple[int, int] = (-1, -1)
        self.extent: tuple[int, int] = (-1, -1)
        self.bf_weights: list[float] = []

        # generic parameters: insertion-ordered {name: list-of-values}
        self._params: dict[str, list[str]] = {}
        self._iter: dict[str, int] = {}
        self._exps: int = 1
        self._current_exp: int = 0

        if clone is not None:
            self.__dict__.update({
                k: (v.copy() if isinstance(v, (list, dict)) else v)
                for k, v in clone.__dict__.items()
            })
            self._params = {k: list(v) for k, v in clone._params.items()}
            self._iter = dict(clone._iter)
        if filename is not None:
            self.read(filename)

    # ------------------------------------------------------------------ parse
    def read(self, filename: str) -> None:
        """Parse a tab-separated .cfg file (parameter_list.cpp:34-229)."""
        with open(filename) as f:
            for raw in f:
                line = raw.rstrip("\n")
                if not line:
                    continue
                # first token up to a tab; '#' comments
                parts = line.split("\t")
                name = parts[0].strip()
                if not name or name.startswith("#"):
                    continue
                values = [p for p in parts[1:] if p.strip() != "" and not p.strip().startswith("#")]
                # drop trailing comment within a value cell
                values = [v.split("#")[0].strip() for v in values]
                values = [v for v in values if v]
                if not values:
                    continue
                value = values[0]
                self._read_entry(name, value, values)

    def _read_entry(self, name: str, value: str, values: list[str]) -> None:
        if name == "id":
            self.id_list.append(_atoi(value)); return
        if name == "name":
            self.name_list.append(value); return
        if name == "category":
            self.category_list.append(value); return
        if name == "file":
            self.file = value; self.file_list.append(value); return
        if name == "file_gt":
            self.file_gt = value; self.file_gt_list.append(value); return
        if name == "occlusions":
            self.occlusions_list.append(value); return
        if name == "output":
            self.output = value; return
        if name == "start":
            self.sequence_start = _atoi(value)
            self.sequence_start_list.append(self.sequence_start)
            return
        if name == "jet_estimation":
            self.jet_estimation.append(value)
            # NOTE: the reference falls through and ALSO stores these keys in
            # the generic map (parameter_list.cpp:113-130 have no continue),
            # where overwrite keeps only the last value.
            self.insert(name, _parse_value_list(value), overwrite=True)
            return
        if name == "jet_weight":
            self.jet_weight.append(_atof(value))
            self.insert(name, _parse_value_list(value), overwrite=True)
            return
        if name == "jet_fps":
            self.jet_fps.append(_atoi(value))
            self.insert(name, _parse_value_list(value), overwrite=True)
            return
        if name == "jet_S":
            self.jet_S.append(_atoi(value))
            self.insert(name, _parse_value_list(value), overwrite=True)
            return
        if name == "F":
            self.F = _atoi(value)
            self.pixel = [[] for _ in range(self.F)]
            self.set = [0] * self.F
            return
        if name == "Jets":
            self.Jets = _atoi(value); return
        if name == "pixel":
            i = _atoi(value) - 1
            if 0 <= i < self.F:
                for coord in values[1:]:
                    xy = coord.split(",")
                    if len(xy) >= 2:
                        self.pixel[i].append((_atof(xy[0]), _atof(xy[1])))
                        self.set[i] += 1
            return
        if name == "center":
            xy = value.split(",")
            if len(xy) >= 2:
                self.center = (int(_atof(xy[0])), int(_atof(xy[1])))
            return
        if name == "extent":
            xy = value.split(",")
            if len(xy) >= 2:
                self.extent = (int(_atof(xy[0])), int(_atof(xy[1])))
            return
        if name == "bf_weight":
            i = _atoi(value)
            if i > 0:
                i -= 1
            if len(values) > 1:
                while len(self.bf_weights) <= i:
                    self.bf_weights.append(0.0)
                self.bf_weights[i] = _atof(values[1])
            return
        if name == "verbose":
            self.verbose = value
            # falls through to the generic map for backward compatibility
            # (parameter_list.cpp:210-213)
        self.insert(name, _parse_value_list(value), overwrite=True)

    # -------------------------------------------------------------- accessors
    def insert(self, param: str, val, overwrite: bool = False) -> None:
        vals = [val] if isinstance(val, str) else list(val)
        if param in self._params:
            if overwrite:
                self._params[param] = vals
            else:
                self._params[param].extend(vals)
        else:
            self._params[param] = vals
            self._iter[param] = 0
        self._exps = math.prod(len(v) for v in self._params.values())

    def exists(self, param: str) -> bool:
        return param in self._params

    def _current(self, param: str) -> str:
        return self._params[param][self._iter.get(param, 0)]

    def set_parameter(self, param: str, value) -> None:
        value = str(value)
        if not self.exists(param):
            self.insert(param, value)
        else:
            self._params[param][self._iter.get(param, 0)] = value

    setParameter = set_parameter

    def parameter(self, param: str, default: str | None = None, type=str):
        """Typed getter with inline default (parameter_list.cpp:658-723)."""
        if not self.exists(param):
            if default is None:
                raise KeyError(f"Parameter {param} does not exist!")
            raw = default
        else:
            raw = self._current(param)
        if type is str:
            return raw
        if type is bool:
            return _to_bool(raw)
        if type is int:
            return _atoi(raw)
        if type is float:
            return _atof(raw)
        raise TypeError(type)

    def split_parameter(self, param: str, default: str = "", type=int):
        """Comma-separated parameter -> list (parameter_list.cpp:726-791)."""
        raw = self._current(param) if self.exists(param) else default
        if not raw:
            return []
        conv = _atoi if type is int else _atof
        return [conv(p) for p in raw.split(",") if p.strip()]

    def maximum(self, param: str) -> int:
        if not self.exists(param):
            raise KeyError(param)
        return max([0] + [_atoi(v) for v in self._params[param]])

    def minimum(self, param: str) -> int:
        if not self.exists(param):
            raise KeyError(param)
        return min([0] + [_atoi(v) for v in self._params[param]])

    def verbosity(self, state: int) -> bool:
        return state < len(self.verbose) and self.verbose[state] == "1"

    # ---------------------------------------------------------- experiments
    def experiment(self) -> int:
        return self._current_exp

    def experiments(self) -> int:
        return self._exps

    def reset(self) -> None:
        for k in self._iter:
            self._iter[k] = 0
        self._current_exp = 0

    def has_next_exp(self) -> bool:
        return self._current_exp < self._exps - 1

    def next_exp(self) -> bool:
        """Odometer-style iteration over the Cartesian experiment grid."""
        if not self.has_next_exp():
            return False
        for name, vals in self._params.items():
            if len(vals) == 1:
                continue
            self._iter[name] += 1
            if self._iter[name] == len(vals):
                self._iter[name] = 0
            else:
                break
        self._current_exp += 1
        return True

    def experiment_name(self) -> str:
        parts = []
        for name, vals in self._params.items():
            if len(vals) == 1:
                continue
            parts.append(f"{name}_{vals[self._iter[name]]}")
        return "_".join(parts)

    # ------------------------------------------------------------- serialize
    def cfg_string(self, all_exps: bool = False) -> str:
        """Round-trip config text (parameter_list.cpp:390-497)."""
        max_len = max([0] + [len(n) for n in self._params])
        tabs = "\t" * (math.ceil(max_len / 8) + 1)
        out = []

        def emit(key, val):
            out.append(f"{key}{tabs}{val}")

        for v in self.id_list:
            emit("id", v)
        for v in self.name_list:
            emit("name", v)
        if self.file_list:
            for v in self.file_list:
                emit("file", v)
        else:
            emit("file", self.file)
        for v in self.category_list:
            emit("category", v)
        if self.file_gt_list:
            for v in self.file_gt_list:
                emit("file_gt", v)
        else:
            emit("file_gt", self.file_gt)
        for v in self.occlusions_list:
            emit("occlusions", v)
        if self.output:
            emit("output", self.output)
            out.append("")
        if self.sequence_start_list:
            for v in self.sequence_start_list:
                emit("start", v)
        else:
            emit("start", self.sequence_start)
        for v in self.jet_estimation:
            emit("jet_estimation", v)
        for v in self.jet_weight:
            emit("jet_weight", v)
        for v in self.jet_fps:
            emit("jet_fps", v)
        for v in self.jet_S:
            emit("jet_S", v)
        emit("F", self.F)
        emit("Jets", self.Jets)
        if self.extent[0] > 0 or self.extent[1] > 0:
            emit("extent", f"{self.extent[0]},{self.extent[1]}")
        if self.center[0] > 0 or self.center[1] > 0:
            emit("center", f"{self.center[0]},{self.center[1]}")
        out.append("")
        special_lists = {
            "jet_estimation": self.jet_estimation, "jet_weight": self.jet_weight,
            "jet_fps": self.jet_fps, "jet_S": self.jet_S,
        }
        for name, vals in self._params.items():
            if name in special_lists and special_lists[name]:
                continue  # already emitted through the special-key lists
            cur = vals[self._iter[name]]
            if len(vals) == 1:
                out.append(f"{name}\t{cur}")
            elif all_exps:
                out.append(f"{name}\t({','.join(vals)})")
            else:
                out.append(f"{name}\t{cur}\t # in ({','.join(vals)})")
        if self.bf_weights:
            out.append("bf_weights\t" + "\t".join(str(v) for v in self.bf_weights))
        return "\n".join(out) + "\n"

    cfgString = cfg_string

    def __str__(self) -> str:
        return self.cfg_string()
