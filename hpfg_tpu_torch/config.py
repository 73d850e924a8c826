"""YAML config system (port of ``hpfg_tpu/config.py``).

The same YAML schema (flat keys plus nested ``model1:`` / ``model2:`` blocks
for dual-model algorithms) loads into an attribute-style mapping; a
``--config`` flag selects the file and dotted ``--set KEY=VALUE`` overrides
are parsed through YAML, so numbers, booleans and lists work. Runtime
objects (writers, loggers, devices) are not attached to the config.
"""

from __future__ import annotations

import argparse
import copy
from typing import Any, Mapping

import yaml


class Config(dict):
    """A dict with attribute access, recursively wrapping nested mappings.

    Unknown attribute reads raise AttributeError (so typos fail loudly), and
    ``cfg.get("key", default)`` keeps normal dict semantics.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict[str, Any] = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(f"Config has no key {key!r}") from exc

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:
            raise AttributeError(f"Config has no key {key!r}") from exc

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML file into a Config; ``overrides`` are dotted-key values
    applied after loading, e.g. ``{"model1.lr": 0.02, "total_itrs": 100}``.
    """
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    if raw is None:
        raw = {}
    if not isinstance(raw, Mapping):
        raise ValueError(f"config root must be a mapping, got {type(raw)}: {path}")
    cfg = Config(raw)
    for key, value in (overrides or {}).items():
        set_dotted(cfg, key, value)
    return cfg


def set_dotted(cfg: Config, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], Config):
            node[part] = {}
        node = node[part]
    node[parts[-1]] = _parse_literal(value)


def _parse_literal(value: Any) -> Any:
    """Parse CLI override strings through YAML so numbers/bools/lists work."""
    if not isinstance(value, str):
        return value
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def config_argparser(description: str, default_config: str) -> argparse.ArgumentParser:
    """Shared CLI for entry scripts: --config plus dotted --set overrides."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=default_config,
                        help="path to the YAML config")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="dotted-key override, e.g. --set total_itrs=100")
    return parser


def parse_config(description: str, default_config: str, argv=None) -> Config:
    parser = config_argparser(description, default_config)
    args = parser.parse_args(argv)
    overrides: dict[str, Any] = {}
    for item in args.overrides:
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, _, value = item.partition("=")
        overrides[key.strip()] = value.strip()
    return load_config(args.config, overrides)
