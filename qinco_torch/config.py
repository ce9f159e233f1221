"""Configuration (counterpart of ``qinco_tpu/config.py``).

The port keeps its own copy of the YAML files under ``configs/`` and of
the loader, so a command line that configures the JAX package configures
this one the same way: ``model_args=<preset>`` overlays, dotted
overrides (``ds.loop=100000``) and the ``encode_profile`` bundles.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any

import yaml

_CONFIG_DIR = Path(__file__).parent / "configs"

# Encode-profile bundles; explicit overrides still win over a bundle.
#   exact  — f32 plain path (the default.yaml state)
#   parity — in-kernel exact top-A + fused select/rebuild, bf16 MLP
#   speed  — binned-argmin kernel (perbin has no effect on the card)
ENCODE_PROFILES = {
    "exact": {},
    "parity": dict(pallas=True, fast_encode=True,
                   compute_dtype="bfloat16", fused_select=True),
    "speed": dict(pallas=True, fast_encode=True,
                  compute_dtype="bfloat16", fused_substep=True,
                  perbin=True, fused_select=True),
}


class Config:
    """Nested attribute/dict-style view over a plain dict tree."""

    def __init__(self, tree: dict):
        object.__setattr__(self, "_tree", tree)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            val = self._tree[name]
        except KeyError:
            raise AttributeError(f"No config key {name!r}") from None
        if isinstance(val, dict):
            return Config(val)
        return val

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._tree[name] = value

    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)

    def __setitem__(self, name: str, value: Any) -> None:
        setattr(self, name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._tree

    def get(self, name: str, default: Any = None) -> Any:
        val = self._tree.get(name, default)
        if isinstance(val, dict):
            return Config(val)
        return val

    def keys(self):
        return self._tree.keys()

    def items(self):
        return self._tree.items()

    def to_dict(self) -> dict:
        return copy.deepcopy(self._tree)

    def __repr__(self) -> str:
        return "Config(" + yaml.safe_dump(self._tree, default_flow_style=False) + ")"


def _deep_update(dst: dict, src: dict) -> dict:
    for key, val in src.items():
        if isinstance(val, dict) and isinstance(dst.get(key), dict):
            _deep_update(dst[key], val)
        else:
            dst[key] = val
    return dst


def _parse_value(text: str) -> Any:
    """Parse a CLI value with YAML semantics; '1e-7' (no dot) is a float."""
    try:
        val = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(val, str):
        try:
            return float(val)
        except ValueError:
            return val
    return val


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot override non-dict key {part!r} in {dotted!r}")
    node[parts[-1]] = value


def available_presets() -> list[str]:
    return sorted(p.stem for p in (_CONFIG_DIR / "model_args").glob("*.yaml"))


def load_config(
    overrides: list[str] | dict | None = None,
    *,
    preset: str | None = None,
) -> Config:
    """Build a config from defaults + optional model preset + overrides.

    ``overrides`` may be a list of ``key=value`` strings (dotted keys
    allowed) or a plain dict.  ``model_args=<preset>`` selects a preset and
    ``encode_profile=<name>`` applies one of :data:`ENCODE_PROFILES`.
    """
    with open(_CONFIG_DIR / "default.yaml") as f:
        tree = yaml.safe_load(f)

    kv_overrides: list[tuple[str, Any]] = []
    if isinstance(overrides, dict):
        kv_overrides = list(overrides.items())
    elif overrides:
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override {item!r} must look like key=value")
            key, _, val = item.partition("=")
            kv_overrides.append((key, _parse_value(val)))

    encode_profile = None
    for key, val in list(kv_overrides):
        if key == "model_args":
            preset = val
            kv_overrides.remove((key, val))
        elif key == "encode_profile":
            encode_profile = val
            kv_overrides.remove((key, val))

    if encode_profile:
        if encode_profile not in ENCODE_PROFILES:
            raise ValueError(
                f"Unknown encode_profile {encode_profile!r}; "
                f"available: {sorted(ENCODE_PROFILES)}"
            )
        kv_overrides = list(ENCODE_PROFILES[encode_profile].items()) + kv_overrides

    if preset:
        preset_path = _CONFIG_DIR / "model_args" / f"{preset}.yaml"
        if not preset_path.exists():
            raise ValueError(
                f"Unknown model preset {preset!r}; available: {available_presets()}"
            )
        with open(preset_path) as f:
            _deep_update(tree, yaml.safe_load(f))

    for key, val in kv_overrides:
        _set_dotted(tree, key, val)

    return Config(tree)
