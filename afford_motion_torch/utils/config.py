"""Minimal Hydra-compatible config system.

The reference drives everything through Hydra + OmegaConf YAML groups
(reference: configs/default.yaml, train.py:53, test.py:140). Neither package
is available here, so this module re-implements the subset the launch
scripts actually use, keeping the YAML schema and the CLI override grammar
1:1 so the reference's 18 shell scripts port unchanged:

- a primary config (``configs/default.yaml``) with a ``defaults`` list
- config groups selected on the CLI (``task=contact_gen model=cdm``)
- dotted overrides (``task.train.batch_size=64``), ``+key=value`` adds
- ``${a.b.c}`` interpolation across the merged tree
- the ``${now:%Y-%m-%d}`` resolver used by ``exp_dir``

Only plain YAML + stdlib are used.
"""
from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2 float semantics so '1e-4' parses as a float
    (the reference configs rely on OmegaConf doing this)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(stream) -> Any:
    return yaml.load(stream, Loader=_YamlLoader)


class DictConfig(dict):
    """A dict with attribute-style access, recursively wrapping sub-dicts."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo):
        return DictConfig({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, DictConfig):
        return value
    if isinstance(value, dict):
        return DictConfig(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def _get_path(tree: Dict[str, Any], dotted: str) -> Any:
    node: Any = tree
    for part in dotted.split("."):
        if isinstance(node, list):
            node = node[int(part)]
        else:
            node = node[part]
    return node


def _set_path(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node: Any = tree
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = {}
        node = node[part]
    node[parts[-1]] = value


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _resolve_value(expr: str, root: Dict[str, Any]) -> Any:
    """Resolve a single ``${...}`` expression body."""
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[len("now:"):])
    return _get_path(root, expr)


def _interpolate(node: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 16:
        raise ValueError("config interpolation too deep (cycle?)")
    if isinstance(node, dict):
        return {k: _interpolate(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root, depth) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.fullmatch(node)
        if m:  # whole-string interpolation keeps the referenced type
            try:
                val = _resolve_value(m.group(1), root)
            except (KeyError, IndexError, TypeError):
                # OmegaConf interpolation is lazy: a dangling reference only
                # errors when accessed. Leave it unresolved (e.g. cdm.yaml's
                # ${task.dataset.use_color} under tasks that don't define it).
                return node
            if isinstance(val, str) and _INTERP_RE.search(val):
                return _interpolate(val, root, depth + 1)
            return _interpolate(val, root, depth + 1) if isinstance(val, (dict, list)) else val

        def sub(match: "re.Match[str]") -> str:
            try:
                val = _resolve_value(match.group(1), root)
                while isinstance(val, str) and _INTERP_RE.fullmatch(val):
                    val = _resolve_value(_INTERP_RE.fullmatch(val).group(1), root)
            except (KeyError, IndexError, TypeError):
                return match.group(0)  # leave unresolved (lazy semantics)
            return str(val)

        out = node
        for _ in range(8):
            new = _INTERP_RE.sub(sub, out)
            if new == out:
                break
            out = new
        return out
    return node


def _parse_override_value(text: str) -> Any:
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def load_config(
    config_dir: Union[str, Path] = "configs",
    overrides: Optional[List[str]] = None,
    config_name: str = "default",
) -> DictConfig:
    """Compose a config exactly like the reference's Hydra entrypoints.

    ``overrides`` follow the Hydra CLI grammar used by the reference launch
    scripts (e.g. ``["task=contact_gen", "model=cdm", "task.train.lr=1e-4"]``).
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    with open(config_dir / f"{config_name}.yaml") as f:
        primary = _yaml_load(f) or {}
    primary.pop("hydra", None)

    defaults = primary.pop("defaults", [])
    group_choice: Dict[str, Optional[str]] = {}
    for item in defaults:
        if isinstance(item, dict):
            for g, choice in item.items():
                if g == "_self_":
                    continue
                group_choice[str(g)] = choice if choice not in (None, "null") else None

    # CLI group selections override the defaults list.
    remaining: List[str] = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        key = key.lstrip("+")
        if key.startswith("hydra"):  # hydra framework flags: accepted, ignored
            continue
        if key in group_choice or (config_dir / key).is_dir():
            group_choice[key] = value
        else:
            remaining.append(ov)

    tree: Dict[str, Any] = {}
    for group, choice in group_choice.items():
        if choice is None:
            continue
        with open(config_dir / group / f"{choice}.yaml") as f:
            tree[group] = _yaml_load(f) or {}
    _merge(tree, primary)

    for ov in remaining:
        key, _, value = ov.partition("=")
        _set_path(tree, key.lstrip("+"), _parse_override_value(value))

    tree = _interpolate(tree, tree)
    return DictConfig(tree)


def save_config(cfg: DictConfig, path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(_unwrap(cfg), f, sort_keys=False)
