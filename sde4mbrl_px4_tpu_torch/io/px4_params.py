"""PX4 firmware parameter files (QGroundControl plain-text format).

Copied from ``sde4mbrl_px4_tpu/io/px4_params.py`` (numpy only): the port
may not import the JAX package, whose ``__init__`` imports JAX. A dump
written here is byte-equal to one written there, header line included.

The reference ships a full parameter dump of the real hexacopter
(the reference's ``launch/params_hexa_ahg.params``, 1073 lines) so the
flight setup is reproducible, and pushes individual params at runtime over
``/mavros/param/set`` (``basic_control.py:110-121,147-149``). This module is
the framework's equivalent: parse/emit the same dump format and bulk-apply a
file through any :class:`~sde4mbrl_px4_tpu_torch.cli.mission.VehicleBase` param
surface (``MissionControl.push_params``).

File format (one param per line, ``#`` comments)::

    # Vehicle-Id Component-Id Name Value Type
    1	1	BAT1_N_CELLS	4	6
    1	1	ASPD_SCALE_1	1.000000000000000000	9

``Type`` is the MAV_PARAM_TYPE code; integer codes decode to ``int`` so a
push round-trips the exact firmware value.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np

__all__ = [
    "parse_params_file",
    "dump_params_file",
    "diff_params",
    "MAV_PARAM_INT_TYPES",
]

# MAV_PARAM_TYPE: 1..8 are (U)INT8..64, 9 = REAL32, 10 = REAL64.
MAV_PARAM_INT_TYPES = frozenset(range(1, 9))

ParamValue = Union[int, float]


def parse_params_file(path: str) -> Dict[str, ParamValue]:
    """Parse a QGC plain-text param dump into ``{name: value}``.

    Values with an integer MAV_PARAM_TYPE code become ``int``, the rest
    ``float``. Malformed lines raise ``ValueError`` with the line number —
    a param dump drives a real vehicle, so silent skips are not acceptable.
    """
    params: Dict[str, ParamValue] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            if len(fields) != 5:
                raise ValueError(
                    f"{path}:{lineno}: expected 5 fields "
                    f"(vehicle, component, name, value, type), got {len(fields)}"
                )
            _vid, _cid, name, value_s, type_s = fields
            try:
                type_code = int(type_s)
                if type_code in MAV_PARAM_INT_TYPES:
                    # int() directly so 64-bit values survive exactly (a
                    # float round-trip corrupts > 2^53); PX4 exporters may
                    # still write int params as "4.000000" — accept only a
                    # LOSSLESS float form.
                    try:
                        value: ParamValue = int(value_s)
                    except ValueError:
                        f_val = float(value_s)
                        if f_val != int(f_val):
                            raise ValueError(
                                f"fractional value {value_s!r} on an "
                                f"integer-typed param"
                            )
                        value = int(f_val)
                else:
                    value = float(value_s)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            if name in params and params[name] != value:
                # Multi-component dumps are a different namespace per
                # component; flattening last-wins would push the wrong
                # value to the wrong component. Refuse loudly.
                raise ValueError(
                    f"{path}:{lineno}: duplicate param {name!r} with "
                    f"conflicting values ({params[name]!r} vs {value!r}); "
                    f"multi-component dumps are not supported"
                )
            params[name] = value
    return params


def dump_params_file(path: str, params: Dict[str, ParamValue],
                     vehicle_id: int = 1, component_id: int = 1,
                     header: str = "") -> None:
    """Write ``params`` in the QGC dump format (sorted by name, like PX4's
    own exporter). ``int`` values get type code 6 (INT32), ``float`` 9
    (REAL32) — the two codes PX4 firmware parameters actually use."""
    lines = ["# Onboard parameters dump (sde4mbrl_px4_tpu)"]
    if header:
        lines += [f"# {h}" for h in header.splitlines()]
    lines.append("# Vehicle-Id Component-Id Name Value Type")
    for name in sorted(params):
        v = params[name]
        if isinstance(v, (bool, getattr(np, "bool_", bool))):
            raise TypeError(f"param {name}: bool is not a firmware type")
        if isinstance(v, (int, np.integer)):
            value_s, code = str(int(v)), 6
        else:
            value_s, code = f"{float(v):.18f}", 9
        lines.append(f"{vehicle_id}\t{component_id}\t{name}\t{value_s}\t{code}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def diff_params(current: Dict[str, ParamValue],
                target: Dict[str, ParamValue],
                rtol: float = 1e-6) -> Dict[str, Tuple[ParamValue, ParamValue]]:
    """``{name: (current_or_None, target)}`` for every target param that is
    absent or numerically different in ``current`` — the minimal push set."""
    out: Dict[str, Tuple[ParamValue, ParamValue]] = {}
    for name, tv in target.items():
        cv = current.get(name)
        if cv is None:
            out[name] = (None, tv)
        elif isinstance(tv, float) or isinstance(cv, float):
            if abs(float(cv) - float(tv)) > rtol * max(1.0, abs(float(tv))):
                out[name] = (cv, tv)
        elif int(cv) != int(tv):
            out[name] = (cv, tv)
    return out
