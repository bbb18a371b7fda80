"""Config-driven transform factory (MONAI-bundle ConfigParser stand-in).

Port of ``segmantic_tpu/transforms/registry.py`` (stdlib only, so the same
code), collecting this package's transform classes.

Supports the same user-config surface the reference exposes
(reference: src/segmantic/seg/monai_unet.py:233-262, example config
tests/testing_data/config.json): dicts with ``_target_`` class names,
``@name`` references into a context, ``$expr`` python expressions, and
``_disabled_`` entries. Targets resolve from a registry of this package's
transforms (registered under their MONAI-compatible names) or any dotted
import path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional

from .base import Compose

TRANSFORM_REGISTRY: Dict[str, Callable] = {}


def register_transform(name: str, cls: Optional[Callable] = None):
    """Register a transform class under a config name (also usable as a
    decorator)."""
    if cls is not None:
        TRANSFORM_REGISTRY[name] = cls
        return cls

    def deco(c):
        TRANSFORM_REGISTRY[name] = c
        return c

    return deco


def _register_builtins() -> None:
    from . import intensity, post, spatial

    for mod in (spatial, intensity, post):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and name[0].isupper():
                TRANSFORM_REGISTRY.setdefault(name, obj)
    TRANSFORM_REGISTRY.setdefault("Compose", Compose)
    # MONAI-name aliases whose behavior is covered by existing transforms
    TRANSFORM_REGISTRY.setdefault(
        "EnsureChannelFirstd", TRANSFORM_REGISTRY.get("EnsureTyped")
    )


def _resolve_target(name: str) -> Callable:
    if not TRANSFORM_REGISTRY:
        _register_builtins()
    if name in TRANSFORM_REGISTRY:
        return TRANSFORM_REGISTRY[name]
    if "." in name:
        module_name, attr = name.rsplit(".", 1)
        return getattr(importlib.import_module(module_name), attr)
    raise KeyError(f"Unknown transform target {name!r}")


def _eval_expr(expr: str, context: Dict[str, Any]) -> Any:
    """Evaluate a ``$`` expression. Supports the ``$import pkg; pkg.x`` idiom
    and plain expressions against the context."""
    env: Dict[str, Any] = dict(context)
    body = expr
    while body.lstrip().startswith("import "):
        stmt, _, body = body.partition(";")
        mod = stmt.strip()[len("import ") :].strip()
        top = mod.split(".")[0]
        importlib.import_module(mod)
        env[top] = importlib.import_module(top)
    return eval(body.strip(), {"__builtins__": {}}, env)  # noqa: S307


def _resolve_value(value: Any, context: Dict[str, Any]) -> Any:
    if isinstance(value, str):
        if value.startswith("@"):
            ref = value[1:]
            if ref not in context:
                raise KeyError(f"Unresolved reference {value!r}")
            return _resolve_value(context[ref], context)
        if value.startswith("$"):
            return _eval_expr(value[1:], context)
        return value
    if isinstance(value, dict):
        if "_target_" in value:
            return build_transform(value, context)
        return {k: _resolve_value(v, context) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_value(v, context) for v in value)
    return value


def build_transform(config: Any, context: Optional[Dict[str, Any]] = None) -> Any:
    """Instantiate a transform (tree) from a ``_target_`` config dict.

    Returns None for disabled or empty configs. Lists build to a
    :class:`Compose`.
    """
    context = context or {}
    if config in (None, {}, []):
        return None
    if isinstance(config, (list, tuple)):
        items = [build_transform(c, context) for c in config]
        return Compose([t for t in items if t is not None])
    if not isinstance(config, dict):
        return _resolve_value(config, context)
    if config.get("_disabled_", False):
        return None

    cfg = {k: v for k, v in config.items() if k not in ("_target_", "_disabled_")}
    target = _resolve_value(config["_target_"], context)
    if not callable(target):
        target = _resolve_target(str(target))

    kwargs = {}
    for k, v in cfg.items():
        if k == "transforms" and target is Compose:
            items = v if isinstance(v, (list, tuple)) else [v]
            built = [build_transform(i, context) for i in items]
            kwargs[k] = [t for t in built if t is not None]
        else:
            kwargs[k] = _resolve_value(v, context)
    return target(**kwargs)


def build_pipeline(
    config: Any,
    image_key: str = "image",
    label_key: str = "label",
    extra_context: Optional[Dict[str, Any]] = None,
) -> Optional[Compose]:
    """Build a Compose pipeline from user config with the standard context
    (the reference seeds its ConfigParser with image_key/label_key too)."""
    context = {"image_key": image_key, "label_key": label_key}
    if extra_context:
        context.update(extra_context)
    built = build_transform(config, context)
    if built is None:
        return None
    if isinstance(built, Compose):
        return built.flatten()
    return Compose([built])
