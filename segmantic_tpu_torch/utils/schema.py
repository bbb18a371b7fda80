"""Function-signature-as-config-schema system.

The CLI's config surface is defined by the keyword signature of the entry
function itself: ``default_args_from_signature`` produces a scaffold config
(with ``<required option: T>`` markers), and ``validate_against_signature``
rejects unknown keys and casts strings back to ``Path`` for Path-annotated
parameters. Same contract as the reference's signature-introspection config
system (reference: src/segmantic/utils/cli.py:6-47).
"""

from __future__ import annotations

import inspect
import typing
from pathlib import Path
from typing import Any, Callable, Dict, Union


def _annotation_is_path(param: inspect.Parameter) -> bool:
    ann = param.annotation
    if ann is inspect.Parameter.empty:
        return False
    if isinstance(ann, str):
        # `from __future__ import annotations` leaves string annotations
        return "Path" in ann
    if inspect.isclass(ann):
        return issubclass(ann, Path)
    # Optional[Path] / Union[Path, None]
    origin = typing.get_origin(ann)
    if origin is Union:
        return any(
            inspect.isclass(a) and issubclass(a, Path) for a in typing.get_args(ann)
        )
    return False


def _ann_name(param: inspect.Parameter) -> str:
    ann = param.annotation
    if ann is inspect.Parameter.empty:
        return "Any"
    if isinstance(ann, str):
        return "Path" if _annotation_is_path(param) else ann
    return getattr(ann, "__name__", str(ann))


def required_marker(param: inspect.Parameter) -> str:
    return f"<required option: {_ann_name(param)}>"


def default_args_from_signature(
    fn_or_sig: Union[Callable, inspect.Signature],
) -> Dict[str, Any]:
    """Build a default config dict from a function signature.

    Paths are stringified so the dict is yaml/json serializable; parameters
    without defaults get a ``<required option: T>`` marker.
    """
    sig = (
        fn_or_sig
        if isinstance(fn_or_sig, inspect.Signature)
        else inspect.signature(fn_or_sig)
    )
    out: Dict[str, Any] = {}
    for name, param in sig.parameters.items():
        if param.default is inspect.Parameter.empty:
            out[name] = required_marker(param)
        elif param.default is not None and _annotation_is_path(param):
            out[name] = str(param.default)
        else:
            out[name] = param.default
    return out


def validate_against_signature(
    args: Dict[str, Any],
    fn_or_sig: Union[Callable, inspect.Signature],
) -> Dict[str, Any]:
    """Validate config keys against a signature; cast str → Path where annotated.

    Raises ``ValueError`` on unknown keys (typo protection for user configs).
    """
    sig = (
        fn_or_sig
        if isinstance(fn_or_sig, inspect.Signature)
        else inspect.signature(fn_or_sig)
    )
    valid: Dict[str, Any] = {}
    for key, value in args.items():
        if key not in sig.parameters:
            raise ValueError(f"Unexpected argument {key}")
        param = sig.parameters[key]
        if value and _annotation_is_path(param) and isinstance(value, (str, Path)):
            valid[key] = Path(value)
        elif value and _annotation_is_path(param) and isinstance(value, (list, tuple)):
            # e.g. 'datalist' may be a list of datalist files (multi-dataset)
            valid[key] = [Path(v) for v in value]
        else:
            valid[key] = value
    return valid


# Short aliases matching common call-sites
get_default_args = default_args_from_signature
validate_args = validate_against_signature
