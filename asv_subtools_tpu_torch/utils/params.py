"""Config utilities (the port's own copy of asv_subtools_tpu/utils/params.py;
parity: pytorch/libs/support/utils.py:319-374 and the launcher param-dict
idiom).

assign_params_dict: recursive typed merge of user params over defaults.
split_params: dotted "section.key" flattening into per-section dicts.
load_yaml / save_yaml: the YAML side of the reference's layered config
(conf/*.yaml egs/feature/augmentation configs).
"""

from __future__ import annotations

import copy
from typing import Any, Dict


def assign_params_dict(
    default_params: Dict,
    params: Dict,
    force_check: bool = False,
    support_unknown: bool = False,
) -> Dict:
    """Merge `params` over `default_params` with type checking.

    Same-key values must have compatible types (int promotes to float);
    dict values merge recursively; unknown keys raise unless
    support_unknown.
    """
    out = copy.deepcopy(default_params)
    default_keys = set(out.keys())
    if force_check:
        for key in params:
            if key not in default_keys:
                raise ValueError(f"params key {key!r} is not in defaults")
    for k, v in out.items():
        if k not in params:
            continue
        pv = params[k]
        if isinstance(v, dict) and isinstance(pv, dict):
            out[k] = assign_params_dict(v, pv, force_check, support_unknown)
        elif v is None or pv is None:
            out[k] = pv
        elif isinstance(v, bool) != isinstance(pv, bool):
            raise ValueError(f"type mismatch for {k!r}: {type(v)} vs {type(pv)}")
        elif isinstance(v, float) and isinstance(pv, int):
            out[k] = float(pv)
        elif isinstance(pv, type(v)) or isinstance(v, type(pv)):
            out[k] = pv
        else:
            raise ValueError(
                f"type mismatch for {k!r}: default {type(v)} vs {type(pv)}"
            )
    if not force_check and support_unknown:
        for key, pv in params.items():
            if key not in default_keys:
                out[key] = pv
    return out


def split_params(params: Dict) -> Dict[str, Dict]:
    """Split dotted keys: {"a.x": 1, "y": 2} -> {"a": {"x": 1}, "public": {"y": 2}}."""
    out: Dict[str, Dict] = {"public": {}}
    for k, v in params.items():
        parts = k.split(".")
        if len(parts) == 2:
            out.setdefault(parts[0], {})[parts[1]] = v
        elif len(parts) == 1:
            out["public"][k] = v
        else:
            raise ValueError(f"expected at most one '.' in key, got {k!r}")
    return out


def load_yaml(path: str) -> Dict:
    # PyYAML is imported here only: nothing on the train or extract path needs it
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(obj: Any, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
